"""PQ-ADC scoring of a query micro-batch: the CUDA kernel and its plain
PyTorch version.

``pq_adc(pq_codes, ids, valid, lut)`` scores candidate ``ids (Q, C)`` of
each query against its LUT ``(Q, M, K)``: ``d = Σ_m lut[q, m, code[id, m]]``
on valid slots, ``+inf`` where ``valid`` is false.  An invalid slot's id is
never read, so any in-range value there gives the same output.  It replaces the TPU
kernel ``repro.kernels.pq_adc.pq_adc`` and the jnp scoring in
``repro.anns.stages.adc_score``; the kernel source is ``csrc/pq_adc.cu``.
The kernel scores valid slots only, and reads a code row as M/16 16-byte
loads where M % 16 == 0 and the code store is 16-byte aligned, as M/4
4-byte words where M % 4 == 0 and it is 4-byte aligned, else as M bytes;
all three sum a row's M lookups in the same order, so a row's distance
does not depend on its slot or on the path.  It holds the query's LUT in
shared memory where it fits (``ops.adc_form``), else (the global form)
stages it there a chunk of subspaces at a time (``ops.adc_plan``), each
row's sum carried in a register from chunk to chunk: the same sums, so the
same bits.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ops
from repro_torch.quant.pq import adc_distances

#: launches of the CUDA kernel (the plain version does not count), and of
#: them the global form's
launches = 0
global_launches = 0
#: the global form's chunk plan at its last launch (``ops.AdcPlan``, its
#: shared bytes as the launch asked for them), None before any
last_plan = None

_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
         + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
#: the kernel's row paths (``row_path``) by their number in the source
_PATHS = {"word": 0, "uint4": 1, "byte": 2}


def pq_adc_plain(pq_codes: torch.Tensor, ids: torch.Tensor,
                 valid: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (the kernel's oracle)."""
    d = adc_distances(lut, pq_codes[ids.long()])
    return torch.where(valid, d, torch.full_like(d, float("inf")))


def row_path(m: int, address: int) -> str:
    """How the kernel reads a code row of M bytes from a store at
    ``address``: ``"uint4"`` (M/16 16-byte loads) where M % 16 == 0 and the
    store is 16-byte aligned, ``"word"`` (M/4 4-byte loads) where M % 4 == 0
    and it is 4-byte aligned, else ``"byte"`` (M byte loads)."""
    if m % 16 == 0 and address % 16 == 0:
        return "uint4"
    if m % 4 == 0 and address % 4 == 0:
        return "word"
    return "byte"


def pq_adc(pq_codes: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
           lut: torch.Tensor) -> torch.Tensor:
    """pq_codes (N, M) uint8, ids (Q, C) int32, valid (Q, C) bool,
    lut (Q, M, K) f32 → (Q, C) f32, K ≤ 256.  CPU tensors take the plain
    version; a CUDA tensor launches the kernel in the form its shapes
    select (``ops.adc_form``) or raises."""
    return _pq_adc(pq_codes, ids, valid, lut)


def _pq_adc(pq_codes, ids, valid, lut, *, form: str | None = None):
    """``pq_adc``; ``form`` names the kernel's form instead of the shapes
    (to hold the two forms against each other)."""
    nq, c = ids.shape
    m, k = lut.shape[1], lut.shape[2]
    if ids.device.type == "cpu":
        return pq_adc_plain(pq_codes, ids, valid, lut)
    dev = ids.device
    build.require("pq_codes", pq_codes, dtype=torch.uint8,
                  shape=(pq_codes.shape[0], m), device=dev)
    build.require("ids", ids, dtype=torch.int32, shape=(nq, c), device=dev)
    build.require("valid", valid, dtype=torch.bool, shape=(nq, c), device=dev)
    build.require("lut", lut, dtype=torch.float32, shape=(nq, m, k),
                  device=dev)
    if k > 256:
        raise ValueError(f"pq_adc: K={k} does not fit uint8 codes")
    glob = ops.pick_form("pq_adc", ops.adc_form(m, k), form) == "global"
    plan = ops.adc_plan(m, k) if glob else None
    path = _PATHS[row_path(m, pq_codes.data_ptr())]
    out = torch.empty((nq, c), dtype=torch.float32, device=dev)
    smem = ctypes.c_int(0)
    fn = build.entry("pq_adc", "fatrq_pq_adc", _ARGS)
    status = fn(build.ptr(pq_codes), build.ptr(ids), build.ptr(valid),
                build.ptr(lut), build.ptr(out), nq, c, m, k, path, int(glob),
                plan.subspaces if glob else 0, ctypes.byref(smem),
                torch.cuda.current_stream(dev).cuda_stream)
    build.check("pq_adc", status, "pq_adc")
    global launches, global_launches, last_plan
    launches += 1
    if glob:
        global_launches += 1
        last_plan = ops.launched_plan("pq_adc", plan, smem.value)
    return out
