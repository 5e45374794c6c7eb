"""The port's dry run and roofline (``repro_torch.launch.roofline``,
``launch.dryrun``) against the JAX package's formulas and against
independent counts: model FLOPs and parameter counts for every cell, the
report's keys and properties, the recording mesh's conventions, a step
counted on meta against the same step run on CPU tensors, micro-batches
counted once and multiplied against a whole run, a train step's
gradients owning their storage (no view of a packed all-reduce buffer)
and its live peak growing with depth by less than such buffers would
add, the 80 production cells' statuses, three production cells end to
end, and the vectorised ``steps._assemble`` against the per-rank loop it
replaced."""

import dataclasses
import itertools
import json
import math
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, \
    shape_applicable  # noqa: E402
from repro_torch.launch import dryrun, input_specs, roofline, \
    steps  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch.mesh import LMMesh, make_host_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402

BF16 = torch.bfloat16

def small_cfg(n_layers: int = 2):
    """A 2-layer (or ``n_layers``), d_model-64 dense configuration
    (qwen2.5-3b's family: GQA, QKV bias, tied embeddings)."""
    return dataclasses.replace(ARCHS["qwen2.5-3b"].reduced(),
                               n_layers=n_layers,
                               d_model=64, n_heads=4, n_kv_heads=2,
                               head_dim=16, d_ff=128, vocab=512)


# ------------------------------------------------------ model FLOPs, report


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_model_flops_and_params_match_jax(name):
    cfg, jcfg = ARCHS[name], JARCHS[name]
    assert cfg.params_count() == jcfg.params_count()
    assert cfg.active_params_count() == jcfg.active_params_count()
    for s in SHAPES:
        assert roofline.model_flops_for(cfg, SHAPES[s]) == \
            jroofline.model_flops_for(jcfg, JSHAPES[s])


def test_report_keys_and_properties():
    kw = dict(arch="a", shape="decode_32k", mesh="single", chips=256,
              flops=3e12, hbm_bytes=2e12, coll_bytes=5e9,
              coll_detail={"bytes": {}, "count": {}},
              peak_memory_bytes=4e10, model_flops=1e14)
    rep = roofline.RooflineReport(**kw)
    assert list(rep.to_dict()) == list(jroofline.RooflineReport(
        **kw).to_dict())
    assert rep.peak_flops == roofline.PEAK_FLOPS == 989.4e12
    assert rep.compute_s == 3e12 / 989.4e12
    assert rep.memory_s == 2e12 / 3.35e12
    assert rep.collective_s == 5e9 / 50e9
    assert rep.step_time_s == max(rep.compute_s, rep.memory_s,
                                  rep.collective_s) == rep.memory_s
    assert rep.bottleneck == "memory"
    assert rep.useful_flops_ratio == 1e14 / (256 * 3e12)
    assert rep.mfu == 1e14 / (rep.memory_s * 256 * 989.4e12)
    floor = 4e10 / 3.35e12                  # the peak read once
    assert rep.mfu_optimistic == 1e14 / (
        max(rep.compute_s, floor, rep.collective_s) * 256 * 989.4e12)
    f32 = roofline.RooflineReport(**kw, peak_flops=roofline.peak_flops(
        torch.float32))
    assert f32.compute_s == 3e12 / 66.9e12
    assert roofline.peak_flops(BF16) == 989.4e12


# --------------------------------------------------------- recording mesh


def test_recording_mesh_counts_result_bytes_once_per_call():
    mesh = roofline.RecordingMesh(("pod", "data", "model"), (2, 2, 4))
    assert mesh.device.type == "meta" and mesh.coords == (0, 0, 0)
    counter = roofline.StepCounter(mesh)
    x = torch.empty(8, 3, dtype=BF16, device="meta")
    with counter.count():
        g = mesh.all_gather(x, 0, ("data", "model"))
        r = mesh.all_reduce(torch.empty(5, device="meta"), "pod")
        m = mesh.all_reduce(torch.empty(2, device="meta"), "model", "max")
        same = mesh.all_gather(x, 1, ())           # no axis: no collective
    assert g.shape == (64, 3) and g.device.type == "meta"
    assert r.shape == (5,) and same is x and m.shape == (2,)
    coll = counter.counts.coll
    assert coll.count_by_op == {"all-gather": 1, "all-reduce": 2}
    assert coll.bytes_by_op == {"all-gather": 64 * 3 * 2,    # the result
                                "all-reduce": 2 * (5 * 4 + 2 * 4)}  # ring
    with counter.count(repeat=3):
        mesh.all_gather(x, 1, "pod")
    assert coll.count_by_op["all-gather"] == 4
    assert coll.bytes_by_op["all-gather"] == 64 * 3 * 2 + 3 * 8 * 6 * 2
    with pytest.raises(ValueError, match="meta"):
        roofline.RecordingMesh(("data",), (2,), device=torch.device("cpu"))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_empty_factories_move_no_bytes(device):
    """An ``empty`` factory allocates and writes nothing: ``new_empty`` then
    ``copy_`` counts the copy's bytes alone, while the new storage is live;
    the recording mesh's gathered buffer counts no bytes either."""
    src = torch.ones(64, 32, dtype=BF16, device=device)
    dst = torch.empty(64, 32, dtype=BF16, device=device)
    alone = roofline.StepCounter()
    with alone.count():
        dst.copy_(src)
    counter = roofline.StepCounter()
    with counter.count():
        full = src.new_empty(src.shape).copy_(src)
        torch.empty_like(src)
        torch.empty_strided((4, 4), (1, 4), device=device)
        src.new_empty_strided((4, 4), (4, 1))
    assert full.shape == src.shape
    assert counter.counts.bytes == alone.counts.bytes == 3 * 64 * 32 * 2
    assert counter.counts.ops["aten.new_empty"][:2] == [1, 0]
    assert counter.counts.live_peak >= 64 * 32 * 2
    mesh = roofline.RecordingMesh(("data", "model"), (1, 4))
    gathered = roofline.StepCounter(mesh)
    with gathered.count():
        mesh.all_gather(src, 0, "model")
    assert gathered.counts.bytes == 0
    assert gathered.counts.coll.bytes_by_op == {"all-gather": 4 * 64 * 32 * 2}


# ------------------------------------------------ meta against CPU tensors


def _step(kind: str, mesh, num_micro=None, n_layers: int = 2):
    cfg = small_cfg(n_layers)
    api = build_model(cfg)
    if kind == "train":
        return api, steps.make_train_step(
            api, mesh, ShapeConfig("t", 16, 4, "train"), dtype=BF16,
            num_micro=num_micro)
    if kind == "prefill":
        return api, steps.make_prefill_step(
            api, mesh, ShapeConfig("p", 16, 4, "prefill"), dtype=BF16)
    return api, steps.make_decode_step(
        api, mesh, ShapeConfig("d", 32, 4, "decode"), dtype=BF16)


def _cpu_inputs(api, structs, kind):
    """``structs`` with CPU tensors in place of the meta ones: a model from
    a seed, random tokens, an empty cache."""
    gen = torch.Generator().manual_seed(0)
    model = api.init(gen, BF16, device="cpu")
    cfg = api.cfg

    def tokens(t):
        return torch.randint(0, cfg.vocab, t.shape, generator=gen,
                             dtype=t.dtype)
    if kind == "train":
        return (model, None, {k: tokens(v) for k, v in structs[2].items()})
    if kind == "prefill":
        return (model, {k: tokens(v) for k, v in structs[1].items()})
    return (model, tokens(structs[1]), api.init_cache(model, 4, 32, BF16))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_count_equals_cpu_count(kind):
    """The same step counted on the meta device (a recording (1, 1) mesh)
    and run on CPU tensors (``make_host_mesh("cpu")``): FLOPs, bytes and
    every op's calls exactly equal."""
    out = {}
    for dev in ("meta", "cpu"):
        mesh = roofline.RecordingMesh(("data", "model"), (1, 1)) \
            if dev == "meta" else make_host_mesh("cpu")
        api, (fn, structs, _, _, meta) = _step(kind, mesh)
        if dev == "cpu":
            structs = _cpu_inputs(api, structs, kind)
        model, args, arg_bytes = dryrun.place_inputs(structs, meta, mesh)
        out[dev] = dryrun.count_step(fn, meta, model, *args), arg_bytes
    (m, m_args), (c, c_args) = out["meta"], out["cpu"]
    assert m.flops == c.flops > 0
    assert m.bytes == c.bytes > 0
    assert m.ops == c.ops
    assert m_args == c_args and m.live_peak > 0
    assert not m.coll.count_by_op and not c.coll.count_by_op


def test_forward_flops_equal_the_matmuls():
    """The prefill forward's FLOPs: every projection, the two attention
    products over the whole prompt and the LM head at the last position,
    2 · m · n · k each."""
    cfg = small_cfg()
    mesh = roofline.RecordingMesh(("data", "model"), (1, 1))
    api, (fn, structs, _, _, meta) = _step("prefill", mesh)
    model, args, _ = dryrun.place_inputs(structs, meta, mesh)
    counts = dryrun.count_step(fn, meta, model, *args)
    b, s = 4, 16
    d, h, kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.d_ff
    proj = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f
    attn = 2 * (2 * b * h * s * s * hd)
    want = cfg.n_layers * (2 * b * s * proj + attn) + 2 * b * d * cfg.vocab
    assert counts.flops == want
    # torch's own FlopCounterMode gives the same count on the same step
    model, args, _ = dryrun.place_inputs(
        _step("prefill", mesh)[1][1], meta, mesh)
    with torch.utils.flop_counter.FlopCounterMode(display=False) as fc:
        fn(model, *args)
    assert fc.get_total_flops() == want


# -------------------------------------------------------- micro-batches


def _split_bytes(model, specs, mesh) -> dict:
    """Each unit's all-gather result bytes, counted from the specs and
    shapes: a unit (a layer of a stack, or a top-level parameter) gathers
    its split parameters' shards from every rank on the union of their
    axes, so the result holds that many shards of each (copies where a
    parameter's own axes are fewer)."""
    shards, axes = {}, {}
    for name, p in model.named_parameters():
        split = [a for e in specs[name] for a in sh.spec_axes(e)
                 if mesh.axis_size(a) > 1]
        if not split:
            continue
        parts = name.split(".")
        last = max((i for i, q in enumerate(parts) if q.isdigit()),
                   default=0)
        unit = ".".join(parts[:last + 1])
        nbytes = p.numel() * p.element_size() // mesh.axis_size(tuple(split))
        shards[unit] = shards.get(unit, 0) + nbytes
        axes.setdefault(unit, set()).update(split)
    return {u: n * mesh.axis_size(tuple(axes[u])) for u, n in shards.items()}


def test_micro_batches_counted_once_equal_a_whole_run():
    """On a (2, 2) recording mesh, a train step of 2 micro-batches: its
    first micro-batch counted twice plus the update equals a run of both
    (FLOPs, collective bytes and counts); the all-gather bytes equal those
    of the specs, each block gathered twice a micro-batch (forward and
    remat), the tied embedding twice (lookup and LM head), plus the whole
    batch gathered once to deal the micro-batches."""
    runs = []
    for whole in (False, True):
        mesh = roofline.RecordingMesh(("data", "model"), (2, 2))
        api, (fn, structs, _, _, meta) = _step("train", mesh, num_micro=2)
        assert meta["num_micro"] == meta["cost_repeat"] == 2
        if not whole:
            units = _split_bytes(structs[0], meta["specs"]["params"], mesh)
        model, args, _ = dryrun.place_inputs(structs, meta, mesh)
        if whole:
            counter = roofline.StepCounter(mesh)
            with counter.count():
                fn(model, *args)
            runs.append(counter.counts)
        else:
            runs.append(dryrun.count_step(fn, meta, model, *args,
                                          mesh=mesh))
    once, whole = runs
    assert once.flops == whole.flops > 0
    assert once.coll.bytes_by_op == whole.coll.bytes_by_op
    assert once.coll.count_by_op == whole.coll.count_by_op
    blocks = sum(v for k, v in units.items() if k.startswith("blocks."))
    top = sum(v for k, v in units.items() if not k.startswith("blocks."))
    assert blocks > 0 and top > 0
    batch = sum(t.numel() * t.element_size() for t in structs[2].values())
    assert once.coll.bytes_by_op["all-gather"] == \
        2 * (2 * blocks + 2 * top) + batch
    assert once.coll.count_by_op["all-reduce"] > 0


def _counted_train(n_layers: int, monkeypatch):
    """A train step of ``small_cfg(n_layers)`` counted on a (2, 2)
    recording mesh; → (the gradients it handed to ``optimizer.update``,
    its counts, the placed model, its parameters at their whole shapes)."""
    handed = {}
    update = optimizer.update

    def spy(grads, *args, **kwargs):
        handed.update(grads)
        return update(grads, *args, **kwargs)
    monkeypatch.setattr(optimizer, "update", spy)
    mesh = roofline.RecordingMesh(("data", "model"), (2, 2))
    api, (fn, structs, _, _, meta) = _step("train", mesh, n_layers=n_layers)
    assert meta["num_micro"] == 1
    model, args, _ = dryrun.place_inputs(structs, meta, mesh)
    counts = dryrun.count_step(fn, meta, model, *args, mesh=mesh)
    return handed, counts, model, input_specs.params_structs(api, BF16)


def test_train_step_gradients_own_their_storage(monkeypatch):
    """Every gradient the step hands to the update owns its storage: none
    is a view into a unit's packed all-reduce buffer (which such a view
    would keep alive until the update)."""
    handed, _, model, _ = _counted_train(2, monkeypatch)
    assert set(handed) == {n for n, _ in model.named_parameters()}
    for name, g in handed.items():
        assert g.untyped_storage().nbytes() == g.numel() * g.element_size(), \
            name


def test_train_step_peak_grows_by_less_than_pinned_buffers(monkeypatch):
    """Two more blocks raise the step's live peak by less than two blocks'
    whole gradient bytes W (bf16).

    The layout on a (2, 2) mesh in "2d" FSDP mode: each block's matrices
    and biases are split four ways and its norms replicated.  After a
    block's backward the step keeps, until the update, its gradient
    shards (the bytes of its placed parameters, S) and remat's saved
    block input (2 rows × 16 positions × d_model 64, bf16, A): S + A < W
    a block, so two more blocks add less than 2W wherever the peak falls.
    A block whose gradients still viewed its packed, all-reduced buffer
    would keep that whole buffer (W) besides, and two more blocks would
    add more than 2W."""
    peaks, whole, kept = {}, {}, {}
    for n_layers in (2, 4):
        _, counts, model, full = _counted_train(n_layers, monkeypatch)
        peaks[n_layers] = counts.live_peak
        kept[n_layers], whole[n_layers] = (
            sum(p.numel() * p.element_size() for n, p in m.named_parameters()
                if n.startswith("blocks.0.")) for m in (model, full))
        kept[n_layers] += 2 * 16 * 64 * 2
    w = whole[2]
    assert whole[4] == w and kept[4] == kept[2] < w
    assert 0 <= peaks[4] - peaks[2] < 2 * w


# --------------------------------------------------- the production cells


def _expected_status(arch: str, shape: str) -> str:
    if not shape_applicable(ARCHS[arch], SHAPES[shape])[0]:
        return "skipped"
    return "ok"


def test_production_cell_statuses_from_the_builders():
    """All 80 cells through ``dryrun.build`` alone (no step run): 64 build
    (the MoE steps with the batch split, the model-axis prefill and
    decode of zamba2, xlstm and whisper and the batch-1 long_500k decode
    among them), 16 are skipped."""
    got = {}
    for arch, shape, mesh_name in itertools.product(
            sorted(ARCHS), SHAPES, dryrun.MESHES):
        want = _expected_status(arch, shape)
        if want == "skipped":
            got[arch, shape, mesh_name] = want
            continue
        fn, *_, meta = dryrun.build(ARCHS[arch],
                                    dryrun.cell_mesh(mesh_name),
                                    SHAPES[shape])
        got[arch, shape, mesh_name] = "ok" if callable(fn) else "error"
        assert got[arch, shape, mesh_name] == want, (arch, shape, mesh_name)
    counts = {s: list(got.values()).count(s) for s in ("ok", "skipped")}
    assert counts == {"ok": 64, "skipped": 16}


def test_decode_cell_end_to_end():
    """qwen2.5-3b decode_32k on the single pod: the record's keys, FLOPs
    equal to the matmuls of 8 rows against the rank's 2048-position
    chunk of the cache (flash decode), all-gather bytes equal to the
    specs', and a collective-bound step."""
    cfg = ARCHS["qwen2.5-3b"]
    rec = dryrun.run_cell("qwen2.5-3b", "decode_32k", "single", save=False,
                          verbose=False)
    assert rec["status"] == "ok"
    keys = set(jroofline.RooflineReport(
        "a", "s", "m", 1, 1, 1, 1, {}, 1, 1).to_dict())
    assert set(rec) == keys | {"status", "run_s", "meta", "fits"}
    assert "specs" not in rec["meta"] and rec["meta"]["flash_decode"]
    json.dumps(rec)
    b, s = 128 // 16, 32768 // 16
    d, h, kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.d_ff
    proj = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f
    want = cfg.n_layers * (2 * b * proj + 2 * (2 * b * h * s * hd)) + \
        2 * b * d * cfg.vocab
    assert rec["flops_per_dev"] == want
    mesh = dryrun.cell_mesh("single")
    fn, structs, _, _, meta = steps.make_step(cfg, mesh, SHAPES["decode_32k"])
    units = _split_bytes(structs[0], meta["specs"]["params"], mesh)
    blocks = sum(v for k, v in units.items() if k.startswith("blocks."))
    # each block once, the tied embedding twice (lookup and LM head)
    assert rec["coll_detail"]["count"]["all-gather"] == cfg.n_layers + 2
    assert rec["coll_detail"]["bytes"]["all-gather"] == \
        blocks + 2 * units["embed"]
    assert rec["bottleneck"] == "collective" and rec["fits"]
    assert rec["model_flops"] == roofline.model_flops_for(
        cfg, SHAPES["decode_32k"])
    assert rec["step_time_s"] == rec["collective_s"]


def test_prefill_cell_end_to_end_and_the_cli(tmp_path, capsys):
    """qwen2-vl-2b prefill_32k on the single pod through ``main``, with a
    skipped cell and whisper-medium's model-axis decode on both meshes,
    then ``--tables`` from those records."""
    out = str(tmp_path)
    assert dryrun.main(["--arch", "qwen2-vl-2b", "--shape", "prefill_32k",
                        "--out", out]) == 0
    assert dryrun.main(["--arch", "whisper-medium", "--shape", "decode_32k",
                        "--mesh", "both", "--out", out]) == 0
    assert dryrun.main(["--arch", "qwen2.5-3b", "--shape", "long_500k",
                        "--out", out]) == 0
    path = tmp_path / "dryrun" / "qwen2-vl-2b__prefill_32k__single.json"
    rec = json.loads(path.read_text())
    cfg = ARCHS["qwen2-vl-2b"]
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["coll_detail"]["count"] == {"all-gather": cfg.n_layers + 1}
    assert rec["flops_per_dev"] > 0 and rec["hbm_bytes_per_dev"] > 0
    np_ = json.loads((tmp_path / "dryrun" /
                      "whisper-medium__decode_32k__multipod.json").read_text())
    # the self- and cross-attention caches split over model: one
    # all-gather of the head outputs an attention, besides each layer's
    # weights
    assert np_["status"] == "ok" and np_["fits"]
    assert np_["coll_detail"]["count"]["all-gather"] > \
        3 * ARCHS["whisper-medium"].n_layers
    skip = json.loads((tmp_path / "dryrun" /
                       "qwen2.5-3b__long_500k__single.json").read_text())
    assert skip["status"] == "skipped"
    capsys.readouterr()
    assert dryrun.main(["--tables", "--out", out]) == 0
    text = capsys.readouterr().out
    assert "3 ran OK, 1 skipped per spec, 0 failed" in text
    assert "| qwen2-vl-2b | prefill_32k | single | " in text
    assert "| whisper-medium | decode_32k | single | " in text
    assert "| whisper-medium | decode_32k | multipod | " in text


def test_new_modules_import_no_jax():
    code = ("import sys; import repro_torch.launch.dryrun, "
            "repro_torch.launch.roofline; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# ------------------------------------------------------------- _assemble


def _assemble_loop(pieces, spec, full_shape, shard_shape, mesh, axes):
    """``steps._assemble`` as it was: one narrow + copy per rank."""
    full = pieces.new_empty(full_shape)
    mine = {a for e in spec for a in sh.spec_axes(e)}
    sizes = [mesh.axis_size(a) for a in axes]
    for j, coords in enumerate(itertools.product(*map(range, sizes))):
        at = dict(zip(axes, coords))
        if any(at[a] for a in axes if a not in mine):
            continue                     # a copy of a block already put
        view = full
        for d, entry in enumerate(spec):
            ax = mesh.axes(sh.spec_axes(entry))
            if mesh.axis_size(ax) == 1:
                continue
            idx = 0
            for a in ax:
                idx = idx * mesh.axis_size(a) + at.get(a, 0)
            view = view.narrow(d, idx * shard_shape[d], shard_shape[d])
        view.copy_(pieces[j].view(shard_shape))
    return full


NAMES = ("pod", "data", "model")


@pytest.mark.parametrize("spec,axes,shape", [
    (("model", None), ("model",), (12, 5)),                  # one axis
    ((("data", "model"), None), ("data", "model"), (12, 5)),  # a tuple
    (("data", "model"), ("data", "model"), (4, 6)),          # two dims
    ((None, "model"), ("pod", "data", "model"), (5, 6)),     # copies
    ((("pod", "data"), None, "model"), NAMES, (8, 3, 6)),    # tuple + dim
    (("data", None, ("pod", "model")), NAMES, (4, 2, 12)),   # tuple, last
    (("model", "one"), ("model",), (6, 4)),                  # a size-1 axis
])
def test_assemble_equals_the_loop(spec, axes, shape):
    """Every rank's shard cut by ``shard_of`` at its coordinates, packed
    as ``_Units.gather`` packs them; the vectorised ``_assemble`` gives
    the loop's tensor bit for bit, which is the whole tensor."""
    names = NAMES + ("one",)
    sizes = (2, 2, 3, 1)
    full = torch.arange(math.prod(shape), dtype=torch.float64).reshape(
        shape)
    axis_sizes = [sizes[names.index(a)] for a in axes]
    pieces = []
    for coords in itertools.product(*map(range, axis_sizes)):
        at = dict(zip(axes, coords))
        mesh = LMMesh(names, sizes, tuple(at.get(a, 0) for a in names))
        pieces.append(sh.shard_of(full, spec, mesh).reshape(-1))
    pieces = torch.stack(pieces)
    mesh = LMMesh(names, sizes)
    shard = sh.shard_of(full, spec, mesh).shape
    got = steps._assemble(pieces, spec, shape, shard, mesh, axes)
    want = _assemble_loop(pieces, spec, shape, shard, mesh, axes)
    assert torch.equal(got, want) and torch.equal(got, full)
    assert got.is_contiguous()
