"""The port's spans (``rec_pangu_tpu_torch/utils/trace.py``) on the CPU: the
no-op path while no profiler records, what one fused step and one retrieval
request record in the profiler and in the store, the ids they carry, the
store's sessions and its fold, and that a profiled step keeps the bits of an
unprofiled one."""
import json
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rec_pangu_tpu_torch.data import DataLoader, RankingDataset
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.ops import softmax_ce
from rec_pangu_tpu_torch.serving.scorer import make_retrieval_scorer
from rec_pangu_tpu_torch.train import RankTrainer, SequenceTrainer
from rec_pangu_tpu_torch.utils import trace

from conftest import RANKING_SCHEMA

B, L, VOCAB, CHUNK = 16, 8, 300, 128
CONFIG = {"embedding_dim": 8, "max_length": L, "n_heads": 2, "inner_size": 16, "n_layers": 1,
          "item_col": "item_id", "hidden_dropout_prob": 0.0, "attn_dropout_prob": 0.0}
STEP_SPANS = ("train.step", "batch.upload", "batch.check", "batch.wait", "step.forward",
              "step.backward", "ce.forward", "ce.backward", "table.update", "table.sort")
STORED = {"batch.upload", "batch.wait", "ce.forward", "ce.backward", "ce.product"}


def _batch(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, L + 1, B)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    hist = np.where(mask > 0, rng.integers(1, VOCAB, (B, L)), 0).astype(np.int32)
    return {"hist_item_list": hist, "hist_mask_list": mask,
            "target_item": rng.integers(1, VOCAB, B).astype(np.int32)}


def _model():
    torch.manual_seed(0)
    return get_model("SASRec")(enc_dict={"item_id": {"vocab_size": VOCAB}}, config=CONFIG)


def _trainer(model, tmp_path):
    """A SequenceTrainer holding ``model``'s fused step, built by a fit of no
    epoch."""
    trainer = SequenceTrainer(model_ckpt_dir=str(tmp_path), device="cpu")
    trainer.fit(model, [_batch(0)], epoch=0, lr=1e-2, device="cpu", seed=3)
    assert trainer._train_step.fused
    return trainer


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _calls(prof):
    """Each name's count among the profiler's events."""
    return Counter(e.name for e in prof.events())


@pytest.fixture
def span_args(monkeypatch):
    """The (name, argument) of every ``record_function`` entered, in order."""
    seen = []
    real = torch.profiler.record_function

    def recording(name, args=None):
        seen.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    return seen


@pytest.fixture(autouse=True)
def empty_store():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(softmax_ce, "CHUNK_V", CHUNK)


def test_span_reads_the_profilers_own_flag():
    # span() tests this private flag alone: it must follow a profiler's session
    from torch.autograd import profiler

    assert profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiler._is_profiler_enabled is True
        assert trace.span("x") is not trace.OFF
    assert profiler._is_profiler_enabled is False


def test_no_profiler_no_record(tmp_path, small_chunks):
    assert trace.span("train.step", 0, "cpu") is trace.OFF
    assert trace.span("ce.product") is trace.OFF
    trainer = _trainer(_model(), tmp_path)
    trainer._step(_batch(1))
    assert trace.totals() == {}


def test_one_fused_step_records_each_span_once(tmp_path, small_chunks):
    model = _model()
    trainer = _trainer(model, tmp_path)
    rows = model.item_emb.table.shape[0]
    chunks = -(-rows // CHUNK)
    assert chunks >= 2
    _, prof = _profiled(lambda: trainer._step(_batch(1)))
    calls = _calls(prof)
    assert {name: calls[name] for name in STEP_SPANS} == dict.fromkeys(STEP_SPANS, 1)
    assert calls["ce.product"] == 4 * chunks
    got = trace.totals()
    assert set(got) == STORED
    assert got["ce.product"]["calls"] == 4 * chunks
    for name, entry in got.items():
        assert entry["device_s"] is None, name  # no device on the CPU
        assert entry["host_s"] > 0, name
    assert got["batch.wait"]["host_s"] <= got["batch.upload"]["host_s"]
    assert got["ce.product"]["host_s"] <= got["ce.forward"]["host_s"] + got["ce.backward"]["host_s"]


def test_spans_without_a_metric_are_bare_record_functions():
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("train.step", 0, "cpu"):
            for name in ("batch.check", "step.forward", "step.backward", "table.update",
                         "table.sort"):
                assert isinstance(trace.span(name), torch.profiler.record_function), name
            for name in sorted(STORED | {"serve.encode", "serve.score", "serve.select"}):
                assert not isinstance(trace.span(name), torch.profiler.record_function), name


def test_spans_carry_the_step_id_and_reach_the_profiler(tmp_path, small_chunks, span_args):
    trainer = _trainer(_model(), tmp_path)
    trainer._step(_batch(1))
    first = trainer.step

    def two_steps():
        trainer._step(_batch(2))
        trainer._step(_batch(3))

    span_args.clear()
    _, prof = _profiled(two_steps)
    names = set(STEP_SPANS) | {"ce.product"}
    ours = [(name, args) for name, args in span_args if name in names]
    assert Counter(name for name, _ in ours) == Counter(
        {**dict.fromkeys(STEP_SPANS, 2), "ce.product": _calls(prof)["ce.product"]})
    steps = [k for k, (name, _) in enumerate(ours) if name == "train.step"]
    for step, (start, stop) in enumerate(zip(steps, steps[1:] + [len(ours)])):
        assert {args for _, args in ours[start:stop]} == {str(first + step)}
    assert names <= set(_calls(prof))


def test_a_span_on_another_thread_takes_the_open_steps_id(span_args):
    seen = []

    def other():
        with trace.span("ce.backward"):
            seen.append(True)

    def request():
        with trace.span("serve.request", 41, "cpu"):
            worker = threading.Thread(target=other)
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()

    _profiled(request)
    assert seen == [True]
    assert span_args == [("serve.request", "41"), ("ce.backward", "41")]
    assert trace.totals()["ce.backward"]["calls"] == 1


def test_a_retrieval_request_records_its_stages(span_args):
    model = _model()
    retrieve = make_retrieval_scorer(model, topk=5, device="cpu")
    request = {k: v for k, v in _batch(4).items() if k != "target_item"}
    retrieve(request)
    _, prof = _profiled(lambda: retrieve(request))
    names = ("serve.request", "batch.upload", "batch.check", "batch.wait", "serve.encode",
             "serve.score", "serve.select")
    calls = _calls(prof)
    assert {name: calls[name] for name in names} == dict.fromkeys(names, 1)
    got = trace.totals()
    assert set(got) == {"batch.upload", "batch.wait", "serve.encode", "serve.score",
                        "serve.select"}
    assert all(e["calls"] == 1 for e in got.values())
    assert {args for name, args in span_args if name in names} == {"1"}  # the second request


def _top_spans(name, n):
    for i in range(n):
        with trace.span("train.step", i, "cpu"):
            with trace.span(name):
                pass


def test_the_store_holds_the_latest_session():
    _profiled(lambda: _top_spans("batch.upload", 1))
    assert set(trace.totals()) == {"batch.upload"}
    _profiled(lambda: _top_spans("ce.product", 2))
    got = trace.totals()
    assert set(got) == {"ce.product"}
    assert got["ce.product"]["calls"] == 2
    trace.reset()
    assert trace.totals() == {}


def test_profiled_steps_keep_the_bits(tmp_path, small_chunks):
    runs = []
    for profiled in (False, True):
        model = _model()
        trainer = _trainer(model, tmp_path / str(profiled))

        def steps():
            return [float(trainer._step(_batch(k))["loss"].detach()) for k in (1, 2)]

        losses = _profiled(steps)[0] if profiled else steps()
        runs.append((losses, model.item_emb.table.detach().clone(),
                     [p.detach().clone() for p in model.parameters()]))
    (loss_a, table_a, params_a), (loss_b, table_b, params_b) = runs
    assert loss_a == loss_b
    assert torch.equal(table_a, table_b)
    assert all(torch.equal(a, b) for a, b in zip(params_a, params_b))


def test_profile_dir_trace_holds_the_spans(ranking_df, tmp_path):
    ds = RankingDataset(RANKING_SCHEMA, ranking_df[:96])
    model = get_model("DeepFM")(enc_dict=ds.enc_dict, embedding_dim=8, hidden_units=(16,))
    trainer = RankTrainer(model_ckpt_dir=str(tmp_path), device="cpu")
    trainer.fit(model, DataLoader(ds, batch_size=48), epoch=1,
                profile_dir=str(tmp_path / "trace"))
    with open(trainer.trace_path) as f:
        names = {str(e.get("name", "")) for e in json.load(f)["traceEvents"]}
    assert {"train.step", "batch.upload", "batch.check", "batch.wait", "step.forward",
            "step.backward", "table.update", "table.sort"} <= names
    assert trace.totals()["batch.upload"]["calls"] == 2


class _FakeEvent:
    """A CUDA event as the store uses it: reached or not, 2 ms after its start."""

    def __init__(self, reached):
        self.reached = reached

    def query(self):
        return self.reached

    def synchronize(self):
        self.reached = True

    def elapsed_time(self, end):
        return 2.0


def test_a_fold_stops_at_the_first_pair_the_stream_has_not_reached():
    store = trace._Store()
    pairs = [(_FakeEvent(True), _FakeEvent(reached)) for reached in (True, False, True)]
    for start, end in pairs:
        store.add("ce.product", 0.001, (start, end))
    store.fold(wait=False)
    assert store.entries["ce.product"].device_s == pytest.approx(0.002)
    assert [p[2] for p in store.pending] == [pairs[1][1], pairs[2][1]]
    assert len(store.free) == 2  # the folded pair's events, for the next spans
    reused = store.event()
    assert any(reused is e for e in pairs[0])
    store.fold(wait=True)
    assert store.entries["ce.product"].device_s == pytest.approx(0.006)
    assert store.pending == [] and store.entries["ce.product"].calls == 3
