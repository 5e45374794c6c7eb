"""The port's four examples (``examples/*_torch.py``) run on the CPU at the
smallest size each takes: their printed lines (those of the JAX examples
they stand for), FaTRQ's recall against the baseline's and its SSD
fetches, the tiered placement's modelled saving after
``rebalance_tiers()``, the RAG round trip's ids against ``db.query``'s and
the training losses (finite, near the entropy of the random tokens)."""

import importlib
import math
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _example(name: str):
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    return importlib.import_module(name)


def _lines_match(out: str, patterns: list[str]) -> None:
    """Each pattern matches a printed line, in this order."""
    lines = iter(out.splitlines())
    for pat in patterns:
        assert any(re.search(pat, line) for line in lines), \
            f"no line matching {pat!r} in order in:\n{out}"


def test_quickstart(capsys):
    got = _example("quickstart_torch").main(["--device", "cpu",
                                             "--n", "2000"])
    _lines_match(capsys.readouterr().out, [
        r"^generating synthetic embedding dataset \(2k × 128d\)\.\.\.$",
        r"^building index \(PQ → IVF → TRQ encode → calibration\)\.\.\.$",
        r"^  far-memory layout: \{'fast_B': 16, 'far_B': \d+, 'ssd_B': 512\}"
        r" bytes/record$",
        r"^  resolved plan: QueryPlan\(front='ivf', backend='reference'",
        r"^  nearest distance \(query 0\): \d+\.\d{4}$",
        r"^  recall@10: FaTRQ=\d\.\d{3}  baseline=\d\.\d{3}$",
        r"^  SSD fetches/query: FaTRQ=40\.0  baseline=\d+\.\d  \(\d+\.\dx "
        r"fewer\)$",
        r"^  modeled time/query: FaTRQ=\d+us  baseline=\d+us  \(\d+\.\dx "
        r"faster\)$"])
    assert got["recall"] >= got["baseline_recall"] - 0.1
    assert got["ssd"] < got["baseline_ssd"]


def test_tiered(capsys):
    got = _example("tiered_torch").main(["--device", "cpu", "--n", "2000"])
    _lines_match(capsys.readouterr().out, [
        r"^building index \(2k × 128d\)\.\.\.$",
        r"^replaying skewed trace on the all-warm placement",
        r"^  heat observed over 1 batch\(es\); top-3 lists hold \d+% of the "
        r"heat$",
        r"^  per-tier: .*ssd=40\.0acc",
        r"^  modeled: \d+us/query  recall@10=\d\.\d{3}$",
        r"^rebalance_tiers\(\): generation 1, moves:$",
        r"^  warm → hot  \d+ rows$",
        r"^  occupancy: hot=\d+lists/\d+rows  warm=",
        r"^replaying the same trace on the adapted placement\.\.\.$",
        r"^  per-tier: .*hbm=",
        r"^  modeled: \d+us/query  recall@10=\d\.\d{3}$",
        r"^  adaptive placement saves \d+% modeled time on this trace"])
    assert got["generation"] == 1
    assert got["hot_s"] < got["warm_s"]


def test_rag_serving(capsys):
    got = _example("rag_serving_torch").main(["--device", "cpu"])
    _lines_match(capsys.readouterr().out, [
        r"^serving 4 batched RAG requests\.\.\.$",
        r"^  resolved plan: QueryPlan\(front='ivf', backend='reference', "
        r"shards=None, k=5, refine_budget=20, micro_batch=4, mode='fatrq'\)$",
        r"^  retrieved ids \(per request\): \[\[\d+(, \d+){4}\], \[",
        r"^  generated tokens: \[\[",
        r"^  degraded by QoS: False$",
        r"^  retrieval cost breakdown: \{",
        r"^  running ledger \(capacity view\): \{'coarse:hbm'",
        r"^  engine stats: ServeStats\(steps=8, tokens=32, retrievals=4\)$",
        r"^per-stage latency breakdown \(traced\):$",
        r"^    front: wall +\d+\.\d{3} ms \| modeled +\d+\.\d{3} ms",
        r"^   refine: wall",
        r"^   rerank: wall"])
    res = got["result"]
    with torch.no_grad():
        want = got["db"].query(got["embed_fn"](got["prompts"]),
                               plan=got["plan"], k=5)
    assert torch.equal(res.ids, want.ids)
    assert tuple(res.tokens.shape) == (4, 8)


def test_train_lm(capsys, tmp_path):
    state = _example("train_lm_torch").main(
        ["--device", "cpu", "--steps", "6", "--layers", "2", "--batch", "2",
         "--seq", "32", "--ckpt-dir", str(tmp_path)])
    _lines_match(capsys.readouterr().out, [
        r"^arch=qwen2\.5-3b params≈\d+M$",
        r"^step=6 loss: first=\d+\.\d{3} last=\d+\.\d{3} stragglers=\d+ "
        r"skipped=0$"])
    # the batches are uniform random tokens, so the loss can only fall
    # towards their entropy, ln(vocab); at this size it does not fall
    # measurably (it does at the example's own size on the card,
    # chip_smoke.examples_phase), so each loss is held near it
    assert len(state.losses) == 6
    assert all(math.isfinite(v) and abs(v - math.log(8192)) < 0.5
               for v in state.losses)
