"""The row top-k (``ops/kernels/row_topk.py``) on the CPU: its plain version,
which repeats the CUDA kernel's steps, against a stable descending sort
(scores descending, NaN first, ties to the smallest ids) and against
``torch.topk``; the refinement past the first digit; the routes; and the
retrieval scorer's answer."""
import math

import numpy as np
import pytest
import torch

from rec_pangu_tpu_torch.eval.retrieval import l2_normalize
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.ops.kernels import _build
from rec_pangu_tpu_torch.ops.kernels import row_topk as rtk
from rec_pangu_tpu_torch.serving.scorer import make_retrieval_scorer, score_items


def _oracle(scores, k):
    values, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k], ids[:, :k].to(torch.int32)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _random(b, n, seed=0):
    return torch.randn(b, n, generator=torch.Generator().manual_seed(seed))


def _few_values(b, n):
    return torch.randint(-3, 4, (b, n), generator=torch.Generator().manual_seed(1)).float() / 2


def _padded(b, n):
    x = _random(b, n, 2)
    x[:, 40:] = -math.inf  # fewer finite scores than k: the -inf ties cross the k-th place
    return x


def _nan(b, n):
    x = _random(b, n, 3)
    x[torch.rand(b, n, generator=torch.Generator().manual_seed(4)) < 0.01] = math.nan
    x[0] = math.nan
    return x


CASES = {
    "random": (lambda: _random(7, 5000), 200),
    "one value": (lambda: torch.full((3, 3000), 0.25), 100),
    "few values, ties across the k-th": (lambda: _few_values(5, 4001), 150),
    "-inf padding": (lambda: _padded(4, 1000), 100),
    "NaN": (lambda: _nan(6, 2003), 64),
    "k = 1": (lambda: _random(9, 777, 5), 1),
    "k = KMAX": (lambda: _random(4, 3000, 6), rtk.KMAX),
    "k = N, N odd": (lambda: _random(3, 37, 7), 37),
    "N not a multiple of 4": (lambda: _random(5, 10_001, 8), 200),
    "one row": (lambda: _random(1, 9000, 9), 200),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_is_the_stable_sort_and_a_topk_answer(case):
    make, k = CASES[case]
    scores = make()
    values, ids = rtk.row_topk_reference(scores, k)
    want_values, want_ids = _oracle(scores, k)
    assert values.dtype == torch.float32 and ids.dtype == torch.int32
    assert torch.equal(_bits(values), _bits(want_values))
    assert torch.equal(ids, want_ids)
    # a valid torch.topk answer: the same values, ids apart only at tied scores
    lib_values, lib_ids = torch.topk(scores, k, dim=1)
    assert torch.equal(_bits(values), _bits(lib_values))
    differ = ids.long() != lib_ids
    tied = _bits(scores.gather(1, ids.long())) == _bits(scores.gather(1, lib_ids))
    assert not bool((differ & ~tied).any())


@pytest.mark.parametrize("capacity", [150, 151, 300])
def test_a_small_capacity_refines_and_counts_the_rows(capacity):
    scores = torch.cat([_random(6, 4000, 10), torch.full((2, 4000), -1.5), _few_values(2, 4000)])
    k = 150
    before = rtk.refined_rows("cpu")
    values, ids = rtk.row_topk_reference(scores, k, capacity)
    refined = rtk.refined_rows("cpu") - before
    want_values, want_ids = _oracle(scores, k)
    assert torch.equal(_bits(values), _bits(want_values)) and torch.equal(ids, want_ids)
    # a row refines when its first-digit bin and above hold more than the capacity
    u = scores.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    digit = torch.where(u >= 1 << 31, 0xFFFFFFFF - u, u | 1 << 31) >> 20
    kth = digit.sort(dim=1, descending=True).values[:, k - 1:k]
    assert refined == int(((digit >= kth).sum(1) > capacity).sum())
    assert refined >= 4  # the equal and few-valued rows at least


def test_the_refined_count_outlives_inference_mode(monkeypatch):
    monkeypatch.setattr(rtk, "_REFINED", {})
    scores = torch.full((2, 500), 1.0)
    with torch.inference_mode():
        rtk.row_topk_reference(scores, 10, capacity=10)
    rtk.row_topk_reference(scores, 10, capacity=10)
    assert rtk.refined_rows("cpu") == 4


@pytest.mark.parametrize("rows", [1, 3, None])
def test_row_blocks_and_runs_give_the_same_bits(rows):
    scores = torch.cat([_few_values(4, 3001), _random(5, 3001, 11)])
    first = rtk.row_topk_reference(scores, 256, rows=rows)
    again = rtk.row_topk_reference(scores, 256, rows=rows)
    whole = rtk.row_topk_reference(scores, 256)
    for got in (again, whole):
        assert torch.equal(_bits(first[0]), _bits(got[0])) and torch.equal(first[1], got[1])


def test_ties_go_to_the_smallest_ids():
    scores = torch.zeros(2, 1000)
    scores[1, 500:] = 1.0
    values, ids = rtk.row_topk_reference(scores, 200, capacity=rtk.KMAX)
    assert torch.equal(ids[0], torch.arange(200, dtype=torch.int32))
    assert torch.equal(ids[1], torch.arange(500, 700, dtype=torch.int32))
    assert bool((values[1] == 1.0).all())


def test_keys_order_as_torch_topk_orders_scores():
    x = torch.tensor([-math.inf, -1e30, -1.0, -1e-40, -0.0, 0.0, 1e-40, 1.0, 1e30, math.inf,
                      math.nan, -math.nan])
    keys = rtk.order_keys(x)
    assert keys[:-2].tolist() == sorted(keys[:-2].tolist())
    assert len(set(keys[:-2].tolist())) == len(x) - 2
    assert keys[-1] == keys[-2] == 0xFFFFFFFF  # every NaN above +inf


@pytest.mark.parametrize("k,n,takes", [(1, 1, True), (256, 256, True), (256, 10**6, True),
                                       (257, 10**6, False), (0, 10, False), (11, 10, False),
                                       (200, 2**31, False)])
def test_kernel_takes_and_the_card_routes_at_the_limits(k, n, takes):
    assert rtk.kernel_takes(k, n) is takes
    before = rtk.PLAIN_ROUTE
    assert rtk.routes_to_kernel(torch.device("cpu"), k, n) is False
    assert rtk.PLAIN_ROUTE == before
    assert rtk.routes_to_kernel(torch.device("cuda"), k, n) is takes
    assert rtk.PLAIN_ROUTE == before + (not takes)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("the CPU path built a kernel")

    monkeypatch.setattr(_build, "build_all", no_build)
    monkeypatch.setattr(rtk, "_FN", None)
    launches, plain = rtk.LAUNCHES, rtk.PLAIN_ROUTE
    scores = _random(4, 2000, 12)
    values, ids = rtk.row_topk(scores, 50)
    assert torch.equal(ids, _oracle(scores, 50)[1])
    values, ids = rtk.row_topk(scores, 300)  # past KMAX: torch.topk, int32 ids
    assert ids.dtype == torch.int32 and torch.equal(values, torch.topk(scores, 300).values)
    assert (rtk.LAUNCHES, rtk.PLAIN_ROUTE, rtk._FN) == (launches, plain, None)
    with pytest.raises(ValueError, match="CUDA"):
        rtk.launch(scores, 50)


@pytest.mark.parametrize("bad", ["float64", "1-D", "strided", "k = 0", "k > N", "capacity < k"])
def test_calls_no_route_takes_raise(bad):
    scores = _random(4, 100, 13)
    k, capacity = 10, rtk.CAPACITY
    if bad == "float64":
        scores = scores.double()
    elif bad == "1-D":
        scores = scores[0]
    elif bad == "strided":
        scores = scores[:, ::2]
    elif bad == "k = 0":
        k = 0
    elif bad == "k > N":
        k = 101
    else:
        capacity = 5
    with pytest.raises(ValueError):
        if bad == "capacity < k":
            rtk.row_topk_reference(scores, k, capacity)
        else:
            rtk.row_topk(scores, k)


def test_plan_and_workspace_at_retrieval_shape():
    assert rtk.workspace_words(1024, 10**6) * 4 <= 28 * 2**20
    assert rtk.plan_slices(1024, 10**6) * 1024 >= rtk.TARGET_BLOCKS
    assert rtk.plan_slices(1, 10**6) == 10**6 // rtk.MIN_SLICE
    assert rtk.plan_slices(4, 100) == 1
    assert rtk.plan_slices(0, 100) == 1


def test_retrieval_scorer_returns_int32_ids_best_first():
    vocab, length = 500, 6
    torch.manual_seed(0)
    model = get_model("SASRec")(enc_dict={"item_id": {"vocab_size": vocab}},
                                config={"embedding_dim": 8, "max_length": length, "n_heads": 2,
                                        "inner_size": 16, "n_layers": 1, "item_col": "item_id"})
    rng = np.random.default_rng(0)
    mask = (np.arange(length)[None, :] < rng.integers(1, length + 1, 12)[:, None])
    batch = {"hist_item_list": np.where(mask, rng.integers(1, vocab, (12, length)), 0)
             .astype(np.int32), "hist_mask_list": mask.astype(np.float32)}
    retrieve = make_retrieval_scorer(model, topk=40, device="cpu")
    scores, ids = retrieve(batch)
    assert scores.dtype == np.float32 and ids.dtype == np.int32
    assert scores.shape == ids.shape == (12, 40)
    assert bool((np.diff(scores, axis=1) <= 0).all())
    with torch.inference_mode():
        user = model(model.upload_batch(batch, torch.device("cpu")))["user_emb"]
        items = model.output_items()
        full = score_items(l2_normalize(user), l2_normalize(items))
    want_values, want_ids = _oracle(full, 40)
    np.testing.assert_array_equal(ids, want_ids.numpy())
    np.testing.assert_array_equal(scores, want_values.numpy())
