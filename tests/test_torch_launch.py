"""The port's launch specs (``repro_torch.launch.shardings``,
``input_specs``, ``steps.choose_microbatches``) against the JAX
package's, in one process, for all ten architectures at their published
widths: the port's structs on the meta device, JAX's through
``jax.eval_shape``, the meshes fake (16, 16) and (2, 16, 16) ones (the
spec functions read only axis names and sizes, as
``tests/test_launch.py`` has it)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import shape_applicable  # noqa: E402
from repro.launch import input_specs as jispec  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch import input_specs as ispec  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import LMMesh, dp_axes, \
    mesh_axis_sizes  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

MESHES = {"pod": (("data", "model"), (16, 16)),
          "multi_pod": (("pod", "data", "model"), (2, 16, 16))}
DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.int32): torch.int32}
CACHE_SHAPES = ("decode_32k", "long_500k")


def _meshes(which: str):
    """(the JAX package's fake mesh, the port's layout-only mesh)."""
    names, shape = MESHES[which]

    class FakeMesh:
        axis_names = names

        class devices:
            pass
    FakeMesh.devices.shape = shape
    FakeMesh.devices.size = int(np.prod(shape))
    return FakeMesh, LMMesh(names, shape)


@functools.lru_cache(maxsize=None)
def _structs(name: str):
    """(JAX's params by path → (shape, dtype), the port's meta model)."""
    jparams = jispec.params_structs(jbuild_model(JARCHS[name]))
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    leaves = {_path(p): (tuple(leaf.shape), leaf.dtype) for p, leaf in flat}
    return jparams, leaves, ispec.params_structs(build_model(ARCHS[name]))


def _path(path) -> str:
    return jax.tree_util.keystr(path).replace("']['", "/").strip("[']")


def _norm(spec) -> tuple:
    """Each entry as a tuple of axis names: JAX's ``PartitionSpec`` keeps
    ``("data",)`` as ``"data"``, the port keeps the data axes' tuple."""
    return tuple(sh.spec_axes(e) for e in spec)


def _flat_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {_path(p): _norm(s) for p, s in flat}


def _flat_port(tree: dict, prefix: str = ""):
    """(path "a/b", spec) of the port's nested spec dicts."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_port(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", _norm(v)


def test_mesh_helpers():
    for which, (names, shape) in MESHES.items():
        jmesh, mesh = _meshes(which)
        assert mesh_axis_sizes(mesh) == dict(zip(names, shape))
        assert dp_axes(mesh) == tuple(a for a in names if a != "model")
        assert mesh.size == jmesh.devices.size


@pytest.mark.parametrize("which", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_specs_match_jax(name, which):
    """Every port parameter's spec is JAX's for its leaf (stack dims
    dropped, transposed for an ``nn.Linear``), its shape is the leaf's,
    and every JAX leaf is some parameter's: both modes, fsdp on and off."""
    jparams, leaves, model = _structs(name)
    jmesh, mesh = _meshes(which)
    params = dict(model.named_parameters())
    for mode in ("2d", "fsdp"):
        for fsdp in (True, False):
            want = _flat_specs(jsh.param_specs(jmesh, jparams, fsdp=fsdp,
                                               mode=mode))
            got = sh.param_specs(mesh, model, fsdp=fsdp, mode=mode)
            covered = set()
            for pname, spec in got.items():
                path, shape, linear = sh.jax_leaf(model, pname)
                assert shape == leaves[path][0], pname
                lead = len(shape) - params[pname].dim()
                assert lead == sum(p.isdigit() for p in pname.split("."))
                assert shape[lead:] == tuple(params[pname].shape)[
                    ::-1 if linear else 1]
                j = want[path]
                assert not any(j[:lead]), (pname, j)
                assert _norm(spec) == (j[lead:][::-1] if linear
                                       else j[lead:]), \
                    (pname, mode, fsdp, spec, j)
                covered.add(path)
            assert covered == set(leaves)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cache_and_batch_specs_match_jax(name):
    """``cache_specs`` at decode_32k and at long_500k (batch 1, the
    sequence fallback), ``batch_specs`` of every cell's batch and decode
    tokens, on both meshes; the host ``len`` has no spec (JAX's is P())."""
    jcfg, cfg = JARCHS[name], ARCHS[name]
    japi, api = jbuild_model(jcfg), build_model(cfg)
    for which in MESHES:
        jmesh, mesh = _meshes(which)
        for sname in CACHE_SHAPES:
            shape = SHAPES[sname]
            jc = jispec.cache_structs(japi, shape.global_batch,
                                      shape.seq_len)
            c = ispec.cache_structs(api, shape.global_batch, shape.seq_len)
            want = _flat_specs(jsh.cache_specs(jmesh, jc))
            got = dict(_flat_port(sh.cache_specs(mesh, c)))
            assert want.pop("len") == ()
            assert got == want, (which, sname)
        for sname, shape in SHAPES.items():
            if not shape_applicable(jcfg, JSHAPES[sname])[0]:
                continue
            for mode in ("2d", "fsdp"):
                for jb, b in ((jispec.train_batch_specs(jcfg, JSHAPES[sname]),
                               ispec.train_batch_specs(cfg, shape)),
                              (jispec.prefill_batch_specs(
                                  jcfg, JSHAPES[sname]),
                               ispec.prefill_batch_specs(cfg, shape)),
                              ({"t": jispec.decode_token_specs(
                                  JSHAPES[sname])},
                               {"t": ispec.decode_token_specs(shape)})):
                    want = {k: _norm(v) for k, v in
                            jsh.batch_specs(jmesh, jb, mode=mode).items()}
                    got = sh.batch_specs(mesh, b, mode=mode)
                    assert {k: _norm(v) for k, v in got.items()} == want


def _same_struct(t: torch.Tensor, j) -> None:
    assert t.device.type == "meta"
    assert tuple(t.shape) == tuple(j.shape) and t.dtype == DTYPES[j.dtype]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_input_specs_match_jax(name):
    """Shapes and dtypes of every applicable cell's structs: batches,
    decode tokens, the cache, and the parameters (by leaf)."""
    jcfg, cfg = JARCHS[name], ARCHS[name]
    japi, api = jbuild_model(jcfg), build_model(cfg)
    _, leaves, model = _structs(name)
    for pname, p in model.named_parameters():
        path, shape, _ = sh.jax_leaf(model, pname)
        assert p.device.type == "meta" and p.dtype == DTYPES[leaves[path][1]]
    for sname, shape in SHAPES.items():
        if not shape_applicable(jcfg, JSHAPES[sname])[0]:
            continue
        jshape = JSHAPES[sname]
        if shape.kind == "train":
            pairs = [(ispec.train_batch_specs(cfg, shape),
                      jispec.train_batch_specs(jcfg, jshape))]
        elif shape.kind == "prefill":
            pairs = [(ispec.prefill_batch_specs(cfg, shape),
                      jispec.prefill_batch_specs(jcfg, jshape))]
        else:
            _same_struct(ispec.decode_token_specs(shape),
                         jispec.decode_token_specs(jshape))
            jc = jispec.cache_structs(japi, jshape.global_batch,
                                      jshape.seq_len)
            c = ispec.cache_structs(api, shape.global_batch, shape.seq_len)
            assert c["len"] == 0
            flat = jax.tree_util.tree_flatten_with_path(jc)[0]
            pairs = [({_path(pth): t for pth, t in _flat_tensors(c)},
                      {_path(pth): leaf for pth, leaf in flat
                       if leaf.ndim})]
        for got, want in pairs:
            assert set(got) == set(want), sname
            for k in want:
                _same_struct(got[k], want[k])


def _flat_tensors(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_tensors(v, prefix + (k,))
        elif isinstance(v, torch.Tensor):
            yield tuple(jax.tree_util.DictKey(p) for p in prefix + (k,)), v


@pytest.mark.parametrize("which", sorted(MESHES))
def test_choose_microbatches_matches_jax(which):
    jmesh, mesh = _meshes(which)
    for name in sorted(ARCHS):
        for sname, shape in SHAPES.items():
            if shape.kind != "train":
                continue
            for seq_parallel in (True, False):
                for budget in (4e9, 1e8):
                    assert steps.choose_microbatches(
                        ARCHS[name], shape, mesh, seq_parallel=seq_parallel,
                        budget_bytes=budget) == jsteps.choose_microbatches(
                        JARCHS[name], JSHAPES[sname], jmesh,
                        seq_parallel=seq_parallel, budget_bytes=budget)


@pytest.mark.parametrize("sname", sorted(SHAPES))
def test_make_step_dispatches_on_a_layout_only_mesh(sname):
    """``make_step`` builds each kind's step for qwen2.5-3b at its
    published widths on the fake (16, 16) mesh (the builders read only
    the mesh's names and sizes): five values, every parameter's
    placements those of its spec, the reference's micro-batching."""
    jmesh, mesh = _meshes("pod")
    shape = SHAPES[sname]
    fn, structs, in_pl, out_pl, meta = steps.make_step(
        ARCHS["qwen2.5-3b"], mesh, shape)
    assert callable(fn) and meta["cost_repeat"] >= 1
    model = structs[0]
    assert {n for n, _ in model.named_parameters()} == \
        set(meta["specs"]["params"]) == set(in_pl[0])
    for name, spec in meta["specs"]["params"].items():
        assert in_pl[0][name] == sh.named(mesh, spec)
    if shape.kind == "train":
        assert meta["num_micro"] == jsteps.choose_microbatches(
            JARCHS["qwen2.5-3b"], JSHAPES[sname], jmesh, seq_parallel=False)
        assert meta["tensor_parallel"] is False and \
            meta["seq_parallel"] is False
    if shape.kind == "decode":
        # 2 KV heads on a 16-way model axis: the sequence is split, over
        # the model axis, or over the data axis for a batch of 1 (the
        # KV heads then whole)
        assert meta["flash_decode"] is True
        assert tuple(map(sh.spec_axes, meta["specs"]["cache"]["k"])) == (
            ((), (), ("data",), (), ()) if shape.global_batch % 16 else
            ((), ("data",), ("model",), (), ()))
