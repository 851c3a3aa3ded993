"""The CUDA kernels (gather_score and the fused beam step, K1, also as the
insert build's searches; the class-max scans, K2, K3 and K4,
the edges of classmax2_scan.cu's keep1 and keep2 scans and of K4; K5, its
edges, and K6 and its chunk runs; regen_rows and regen_score of the
capacity path) against their plain twins, on a card; the IVF index, which
has no kernel of its own, against the CPU; ROADMAP C11, one query's
answer at any batch size, for every family; and the sharded HNSW search
stacked on the card: one answer, bit for bit, across shard counts,
exchanges, the replica and routing, and equal to a CPU mesh on integer
rows; the sharded scan families (FastFlat, split, IVF, routed) on a card
mesh equal to a CPU mesh on integer rows, their kernels at per-shard shapes,
and C11 for the sharded FastFlat, split and IVF.

Every test here needs a CUDA card and nvcc and skips without them. The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_kernel.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from shine_tpu_torch import HNSWIndex
from shine_tpu_torch.config import HNSWParams, SearchParams
from shine_tpu_torch.graph.soa import build_graph
from shine_tpu_torch.io import synthetic_dataset
from shine_tpu_torch.models import hnsw as th
from shine_tpu_torch.models.hnsw import quantize_rows
from shine_tpu_torch.ops import beam_step as bs
from shine_tpu_torch.ops.beam import Beam
from shine_tpu_torch.ops.gather_score import gather_score, gather_score_ref

pytestmark = pytest.mark.cuda

# distances here are O(1e2) (L2) and the kernel sums in another order
RTOL, ATOL = 1e-5, 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(rng, n, B, K, d, rows, l2, dev):
    tables = {k: v.to(dev) for k, v in quantize_rows(
        rng.normal(size=(n, d)).astype(np.float32), rows).items()}
    vectors = tables.pop("vectors_ext")
    if not l2:
        tables.pop("row_nrm", None)
    q = rng.normal(size=(B, d)).astype(np.float32)
    ids = rng.integers(0, n, size=(B, K)).astype(np.int32)
    ids[rng.random((B, K)) < 0.1] = -1
    q_ext = (-2.0 * q if l2 else -q).astype(np.float32)
    bias = ((q * q).sum(1) if l2 else np.ones(B)).astype(np.float32)
    args = [vectors] + [torch.from_numpy(a).to(dev) for a in (q_ext, bias, ids)]
    return args, dict(tables, l2=l2)


@pytest.mark.parametrize("d", [8, 16, 24, 32, 128, 960])
@pytest.mark.parametrize("rows", ["f32", "bf16", "int8"])
def test_kernel_matches_twin(card, rows, d):
    rng = np.random.default_rng(d)
    for l2 in (True, False):
        args, kw = _case(rng, 3000, 16, 96, d, rows, l2, card)
        before = gather_score.launches
        got = gather_score(*args, **kw)
        torch.cuda.synchronize()
        assert gather_score.launches == before + 1
        want = gather_score_ref(*args, **kw)
        assert torch.equal(torch.isinf(got), args[3] < 0)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_kernel_marks_out_of_range_ids_nan(card):
    args, kw = _case(np.random.default_rng(1), 100, 2, 8, 32, "f32", True, card)
    args[3][0, 0] = 100
    got = gather_score(*args, **kw)
    assert torch.isnan(got[0, 0]) and torch.isfinite(got[0, 1:][args[3][0, 1:] >= 0]).all()


def test_kernel_rejects_cpu_mixed_inputs(card):
    args, kw = _case(np.random.default_rng(2), 100, 2, 8, 32, "f32", True, card)
    args[1] = args[1].cpu()
    with pytest.raises(ValueError):
        gather_score(*args, **kw)


def test_search_on_card_matches_cpu(card):
    ds = synthetic_dataset(n=4000, dim=32, num_queries=128, seed=5,
                           compute_gt=False)
    graph = build_graph(ds.base, HNSWParams(M=8, ef_construction=64), threads=1)
    sp = SearchParams(k=10, ef=48, frontier=4)
    for rows in ("f32", "bf16", "int8"):
        a, da = HNSWIndex(graph, rows=rows, device="cpu").search(
            ds.queries, sp, batch_size=64)
        before = bs.beam_step.launches
        b_idx = HNSWIndex(graph, rows=rows, device=card)
        b, db = b_idx.search(ds.queries, sp, batch_size=64)
        assert bs.beam_step.launches - before >= b_idx.last_steps > 0
        assert (a == b).mean() >= 0.99
        same = a == b
        np.testing.assert_allclose(db[same], da[same], rtol=RTOL, atol=ATOL)


# --- the class-max scan (K2) -------------------------------------------------

# K2 scores sum dp bf16 products, each exact in f32, in another order than
# the twin's f32 matmul: at most dp * 2^-23 * sum|products|; the tables below
# keep sum|products| under ~1e3 at dp=960, so the bound is ~0.12
K2_ATOL = 0.25


def _k2_case(rng, n_pad, d, B, dev, pad_rows=0):
    from shine_tpu_torch.ops.scan import ext_width, pack_ext_query, pack_ext_table

    v = rng.normal(size=(n_pad - pad_rows, d)).astype(np.float32)
    ext = pack_ext_table(v, 0, n_pad, device=dev)
    q = rng.normal(size=(B, d)).astype(np.float32)
    q_ext = pack_ext_query(torch.from_numpy(q).to(dev), ext_width(d))
    return ext, q_ext.to(torch.bfloat16)


@pytest.mark.parametrize("d", [16, 128, 960])
@pytest.mark.parametrize("B", [256, 77])
@pytest.mark.parametrize("keep2", [False, True])
def test_classmax_kernel_matches_twin(card, d, B, keep2):
    from shine_tpu_torch.ops import classmax as cm

    rng = np.random.default_rng(d + B)
    ext, q = _k2_case(rng, 16384, d, B, card, pad_rows=1000)
    cls = 1024
    fn = cm.classmax2_scan if keep2 else cm.classmax_scan
    before = fn.launches
    got = fn(ext, q, cls=cls)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = cm.classmax2_scan_ref(ext, q, cls=cls)
    for g, w in zip(got[::2], want[::2]):
        torch.testing.assert_close(g, w, rtol=0, atol=K2_ATOL)
    clear = (want[0] - want[2]) > K2_ATOL
    assert clear.float().mean() > 0.9
    assert torch.equal(got[1][clear], want[1][clear])
    lane = torch.arange(cls, device=card, dtype=torch.int32)
    for rows in got[1::2]:
        assert torch.equal(rows % cls, lane.expand_as(rows))


@pytest.mark.parametrize("d", [16, 128, 960])
@pytest.mark.parametrize("keep2", [False, True])
def test_classmax_kernel_integers_bit_for_bit(card, d, keep2):
    """Integer entries in [-4, 4]: the kernel's f32 sums are exact, so it
    must equal the twin bit for bit, ties and all, ragged B included."""
    from shine_tpu_torch.ops import classmax as cm

    rng = np.random.default_rng(d)
    dp = -(-d // 16) * 16
    ext = torch.from_numpy(rng.integers(-4, 5, size=(8192, dp)).astype(
        np.float32)).to(card).to(torch.bfloat16)
    q = torch.from_numpy(rng.integers(-4, 5, size=(200, dp)).astype(
        np.float32)).to(card).to(torch.bfloat16)
    fn, ref = ((cm.classmax2_scan, cm.classmax2_scan_ref) if keep2
               else (cm.classmax_scan, cm.classmax_scan_ref))
    got = fn(ext, q, cls=256)
    want = ref(ext, q, cls=256)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("d", [16, 128, 960])
@pytest.mark.parametrize("keep2", [False, True])
def test_classmax_topk_kernel_equals_unfused_plus_select(card, d, keep2):
    from shine_tpu_torch.ops import classmax as cm

    rng = np.random.default_rng(3 * d)
    ext, q = _k2_case(rng, 8192, d, 300, card)
    cls, kb = 512, 32
    unfused = (cm.classmax2_scan if keep2 else cm.classmax_scan)(ext, q, cls=cls)
    fn = cm.classmax2_topk_scan if keep2 else cm.classmax_topk_scan
    before = fn.launches
    fused = fn(ext, q, cls=cls, kb=kb)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    vals, sel = cm.select_lanes(unfused[0], kb)
    assert torch.equal(fused[0], vals)
    for f, u in zip(fused[1:], unfused[1:]):
        assert torch.equal(f, torch.gather(u, 1, sel))
    twin = (cm.classmax2_topk_scan_ref if keep2 else cm.classmax_topk_scan_ref)(
        ext, q, cls=cls, kb=kb)
    torch.testing.assert_close(fused[0], twin[0], rtol=0, atol=K2_ATOL)


@pytest.mark.parametrize("topk", [False, True])
@pytest.mark.parametrize("keep2", [False, True])
def test_classmax_empty_batch_launches_nothing(card, topk, keep2):
    from shine_tpu_torch.ops import classmax as cm

    ext = torch.zeros(4096, 32, dtype=torch.bfloat16, device=card)
    q = torch.zeros(0, 32, dtype=torch.bfloat16, device=card)
    fn = {(False, False): cm.classmax_scan, (False, True): cm.classmax2_scan,
          (True, False): cm.classmax_topk_scan,
          (True, True): cm.classmax2_topk_scan}[(topk, keep2)]
    kw = {"cls": 256, **({"kb": 8} if topk else {})}
    before = fn.launches
    got = fn(ext, q, **kw)
    assert fn.launches == before
    assert all(g.shape == (0, 8 if topk else 256) and g.is_cuda for g in got)


def test_classmax_kernel_rejects_what_it_cannot_take(card):
    from shine_tpu_torch.ops import classmax as cm

    ext = torch.zeros(4096, 24, dtype=torch.bfloat16, device=card)
    q = torch.zeros(8, 24, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="multiples of 16"):
        cm.classmax_scan(ext, q, cls=256)
    ext = torch.zeros(4096, 32, dtype=torch.bfloat16, device=card)
    q = torch.zeros(8, 32, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="cls % 64"):
        cm.classmax_scan(ext, q, cls=32)
    with pytest.raises(ValueError, match="is on"):
        cm.classmax_scan(ext, q.cpu(), cls=256)


def test_fastflat_on_card_matches_cpu(card):
    from shine_tpu_torch import FastFlatIndex
    from shine_tpu_torch.ops import classmax as cm

    ds = synthetic_dataset(n=20_000, dim=32, num_queries=300, seed=6,
                           compute_gt=False)
    cpu = FastFlatIndex(ds.base, device="cpu")
    gpu = FastFlatIndex(ds.base)  # the card by default
    assert gpu.device.type == "cuda"
    for knobs in ({}, {"kb": 32, "keep2": True, "tq": 256},
                  {"kb": 64, "keep2": True}, {"kb": 16}):
        a, da = cpu.search(ds.queries, 10, **knobs)
        before = sum(f.launches for f in (cm.classmax_scan, cm.classmax2_scan,
                                          cm.classmax_topk_scan,
                                          cm.classmax2_topk_scan))
        b, db = gpu.search(ds.queries, 10, **knobs)
        after = sum(f.launches for f in (cm.classmax_scan, cm.classmax2_scan,
                                         cm.classmax_topk_scan,
                                         cm.classmax2_topk_scan))
        assert after > before
        assert (a == b).mean() >= 0.99
        same = a == b
        np.testing.assert_allclose(db[same], da[same], rtol=RTOL, atol=ATOL)


# --- the split-layout class-max scan (K3) ------------------------------------

_K3_FNS = ("scan", "topk")


def _k3_tables(rng, n_pad, d, B, comp_dtype, dev, real=None, integer=True):
    """Split tables of ``real`` rows (all but 1000 by default) padded to
    n_pad, and (B, dpc) bf16 queries, on ``dev``. Integer rows hold +-127
    in column 0 and small integers elsewhere, so that int8 holds them
    exactly and every score is an exact f32 integer."""
    from shine_tpu_torch.ops.scan_split import pack_split_query, pack_split_tables

    real = n_pad - 1000 if real is None else real
    if integer:
        v = rng.integers(-4, 5, size=(real, d)).astype(np.float32)
        v[:, 0] = np.where(rng.random(real) < 0.5, -127.0, 127.0)
        q = rng.integers(-4, 5, size=(B, d)).astype(np.float32)
    else:
        v = rng.normal(size=(real, d)).astype(np.float32)
        q = rng.normal(size=(B, d)).astype(np.float32)
    comp, aux = pack_split_tables(v, 0, n_pad, comp_dtype=comp_dtype, device=dev)
    return comp, aux, pack_split_query(torch.from_numpy(q).to(dev), comp.shape[1])


def _k3_call(fn, keep2, ref=False, **kw):
    from shine_tpu_torch.ops import classmax as cm

    f = {("scan", False): cm.classmax_scan_split,
         ("topk", False): cm.classmax_topk_scan_split,
         ("scan", True): cm.classmax_scan_split_ref,
         ("topk", True): cm.classmax_topk_scan_split_ref}[(fn, ref)]
    if fn == "scan":
        kw.pop("kb", None)
    return f, lambda comp, aux, q: f(comp, aux, q, keep2=keep2, **kw)


@pytest.mark.parametrize("d", [16, 128, 960])
@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("keep2", [False, True])
@pytest.mark.parametrize("fn", _K3_FNS)
def test_split_kernel_integers_bit_for_bit(card, d, comp_dtype, keep2, fn):
    """Exact integer scores: the kernel equals the twin bit for bit, ties,
    pad rows and all, at a ragged B."""
    rng = np.random.default_rng(d + 7 * keep2)
    comp, aux, q = _k3_tables(rng, 8192, d, 200, comp_dtype, card)
    wrapper, run = _k3_call(fn, keep2, cls=256, kb=24)
    _, twin = _k3_call(fn, keep2, ref=True, cls=256, kb=24)
    before = wrapper.launches
    form_before = dict(wrapper.form_launches)
    got = run(comp, aux, q)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    form = (comp_dtype, keep2)
    assert wrapper.form_launches[form] == form_before.get(form, 0) + 1
    want = twin(comp, aux, q)
    assert len(got) == len(want) == (4 if keep2 else 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("keep2", [False, True])
def test_split_kernel_gaussian_and_fused_equals_unfused(card, comp_dtype, keep2):
    from shine_tpu_torch.ops import classmax as cm

    rng = np.random.default_rng(31 + keep2)
    comp, aux, q = _k3_tables(rng, 16384, 128, 300, comp_dtype, card, integer=False)
    cls, kb = 1024, 32
    unfused = cm.classmax_scan_split(comp, aux, q, cls=cls, keep2=keep2)
    want = cm.classmax_scan_split_ref(comp, aux, q, cls=cls, keep2=True)
    for g, w in zip(unfused[::2], want[::2]):
        torch.testing.assert_close(g, w, rtol=0, atol=K2_ATOL)
    clear = (want[0] - want[2]) > K2_ATOL
    assert clear.float().mean() > 0.9
    assert torch.equal(unfused[1][clear], want[1][clear])
    fused = cm.classmax_topk_scan_split(comp, aux, q, cls=cls, kb=kb, keep2=keep2)
    vals, sel = cm.select_lanes(unfused[0], kb)
    assert torch.equal(fused[0], vals)
    for f, u in zip(fused[1:], unfused[1:]):
        assert torch.equal(f, torch.gather(u, 1, sel))


@pytest.mark.parametrize("fn", _K3_FNS)
@pytest.mark.parametrize("keep2", [False, True])
def test_split_empty_batch_launches_nothing(card, fn, keep2):
    comp = torch.zeros(4096, 32, dtype=torch.int8, device=card)
    aux = torch.ones(2, 4096, device=card)
    q = torch.zeros(0, 32, dtype=torch.bfloat16, device=card)
    wrapper, run = _k3_call(fn, keep2, cls=256, kb=8)
    before, forms = wrapper.launches, dict(wrapper.form_launches)
    got = run(comp, aux, q)
    assert wrapper.launches == before and wrapper.form_launches == forms
    assert all(g.shape == (0, 8 if fn == "topk" else 256) and g.is_cuda for g in got)


@pytest.mark.parametrize("bad", ["width", "wide", "cls", "rows", "aux_shape",
                                 "dtype", "unaligned", "cpu_aux"])
def test_split_kernel_rejects_what_it_cannot_take(card, bad):
    from shine_tpu_torch.ops import classmax as cm

    comp = torch.zeros(4096, 32, dtype=torch.int8, device=card)
    aux = torch.ones(2, 4096, device=card)
    q = torch.zeros(8, 32, dtype=torch.bfloat16, device=card)
    kw = {"cls": 256}
    if bad == "width":
        comp, q = comp[:, :24].contiguous(), q[:, :24].contiguous()
    elif bad == "wide":
        comp = torch.zeros(4096, 1296, dtype=torch.int8, device=card)
        q = torch.zeros(8, 1296, dtype=torch.bfloat16, device=card)
    elif bad == "cls":
        kw = {"cls": 32}
    elif bad == "rows":
        kw = {"cls": 3000}
    elif bad == "aux_shape":
        aux = aux[:, :2048].contiguous()
    elif bad == "dtype":
        comp = comp.half()
    elif bad == "unaligned":
        comp = torch.zeros(4096 * 32 + 8, dtype=torch.int8, device=card)[8:].view(4096, 32)
    elif bad == "cpu_aux":
        aux = aux.cpu()
    with pytest.raises((TypeError, ValueError)):
        cm.classmax_scan_split(comp, aux, q, **kw)


def test_splitflat_on_card_matches_cpu(card):
    from shine_tpu_torch import SplitFlatIndex
    from shine_tpu_torch.ops import classmax as cm

    ds = synthetic_dataset(n=20_000, dim=32, num_queries=300, seed=6,
                           compute_gt=False)
    fns = (cm.classmax_scan_split, cm.classmax_topk_scan_split)
    for comp_dtype in ("bf16", "int8"):
        cpu = SplitFlatIndex(ds.base, comp_dtype=comp_dtype, device="cpu")
        gpu = SplitFlatIndex(ds.base, comp_dtype=comp_dtype)  # the card by default
        assert gpu.device.type == "cuda"
        for knobs in ({}, {"kb": 32, "keep2": True}, {"kb": 64, "keep2": True},
                      {"kb": 16}):
            a, da = cpu.search(ds.queries, 10, **knobs)
            before = sum(f.launches for f in fns)
            b, db = gpu.search(ds.queries, 10, **knobs)
            assert sum(f.launches for f in fns) > before
            assert (a == b).mean() >= 0.99
            same = a == b
            np.testing.assert_allclose(db[same], da[same], rtol=RTOL, atol=ATOL)


# --- the class-max kernel's edges, keep1 and keep2 (csrc/classmax2_scan.cu) ----

_KEEP2_FORMS = ("ext", "bf16", "int8")


def _keep2_inputs(rng, form, n_pad, dp, B, dev, same_rows=False, q_low=-4):
    """Integer inputs of one keep2 form: K2's table ("ext"), or K3's comp
    (bf16 or int8) with an aux of integer nrm, scl in {1, 2, -1} and about
    5% pad rows (comp 0, scl 1, nrm -3e38); every score is exact in f32.
    ``same_rows`` makes every row (and its aux) the same."""
    v = rng.integers(-4, 5, size=(n_pad, dp)).astype(np.float32)
    q = rng.integers(q_low, 5, size=(B, dp)).astype(np.float32)
    q_t = torch.from_numpy(q).to(dev).to(torch.bfloat16)
    if same_rows:
        v[:] = v[0]
    if form == "ext":
        return (torch.from_numpy(v).to(dev).to(torch.bfloat16),), q_t
    aux = np.stack([rng.integers(-8, 9, n_pad),
                    rng.choice([1.0, 2.0, -1.0], n_pad)]).astype(np.float32)
    if not same_rows:
        pad = rng.random(n_pad) < 0.05
        v[pad] = 0.0
        aux[0, pad], aux[1, pad] = -3e38, 1.0
    else:
        aux[:] = aux[:, :1]
    comp = torch.from_numpy(v.astype(np.int8) if form == "int8" else v).to(dev)
    if form == "bf16":
        comp = comp.to(torch.bfloat16)
    return (comp, torch.from_numpy(aux).to(dev)), q_t


def _keep2_pair(form, tables, q, cls, keep=2):
    """(kernel, twin) outputs of the keep1 or keep2 scan of ``form``."""
    from shine_tpu_torch.ops import classmax as cm

    if form == "ext":
        if keep == 1:
            return (cm.classmax_scan(tables[0], q, cls=cls),
                    cm.classmax_scan_ref(tables[0], q, cls=cls))
        return (cm.classmax2_scan(tables[0], q, cls=cls),
                cm.classmax2_scan_ref(tables[0], q, cls=cls))
    return (cm.classmax_scan_split(*tables, q, cls=cls, keep2=keep == 2),
            cm.classmax_scan_split_ref(*tables, q, cls=cls, keep2=keep == 2))


def _same_bits(got, want, planes=4):
    assert len(got) == len(want) == planes
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("keep", [1, 2])
@pytest.mark.parametrize("form", _KEEP2_FORMS)
@pytest.mark.parametrize("case", ["one_member", "cls64", "B1", "B65", "B129", "B257"])
def test_keep2_kernel_edges_bit_for_bit(card, form, case, keep):
    """One member (n_pad == cls), one class tile (cls = 64), B = 1, B = 65
    (one query past a consumer warpgroup), B = 129 (one past a 128-query
    tile) and B = 257 (three tiles, an odd count): bit for bit against the
    twin."""
    n_pad, cls, B = {"one_member": (256, 256, 100), "cls64": (4096, 64, 130),
                     "B1": (4096, 256, 1), "B65": (4096, 256, 65),
                     "B129": (4096, 256, 129), "B257": (4096, 256, 257)}[case]
    rng = np.random.default_rng(len(case) + 10 * len(form))
    tables, q = _keep2_inputs(rng, form, n_pad, 128, B, card)
    got, want = _keep2_pair(form, tables, q, cls, keep)
    torch.cuda.synchronize()
    _same_bits(got, want, 2 * keep)


@pytest.mark.parametrize("keep", [1, 2])
@pytest.mark.parametrize("form", _KEEP2_FORMS)
def test_keep2_kernel_all_scores_equal(card, form, keep):
    """Every row scores the same: the winner is member 0 and the runner-up
    the second-earliest row, member 1."""
    rng = np.random.default_rng(5)
    cls = 256
    tables, q = _keep2_inputs(rng, form, 4096, 64, 70, card, same_rows=True)
    got, want = _keep2_pair(form, tables, q, cls, keep)
    _same_bits(got, want, 2 * keep)
    lane = torch.arange(cls, dtype=torch.int32, device=card).expand(70, cls)
    assert torch.equal(got[1], lane)
    if keep == 2:
        assert torch.equal(got[3], lane + cls)


@pytest.mark.parametrize("keep", [1, 2])
@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_keep2_kernel_signed_zero_ties(card, form, keep):
    """Scores of +0.0 and -0.0 (a zero row's scl * 0 + nrm with nrm = +-0
    and scl = +-1) tie: the earliest row wins with its own sign, the next
    one (keep2) is the runner-up, as the strict > keeps them."""
    rng = np.random.default_rng(17)
    n_pad, dp, cls = 4096, 32, 256
    (comp, aux), q = _keep2_inputs(rng, form, n_pad, dp, 90, card, q_low=0)
    zero = torch.from_numpy(rng.random(n_pad) < 0.5).to(card)
    zero[:cls] = True  # member 0 is all zero rows: every class has a zero score
    comp[zero] = 0
    aux[0] = torch.where(zero, 0.0, -1000.0)
    sign = torch.from_numpy(rng.random(n_pad) < 0.5).to(card)
    aux[0] = torch.where(zero & sign, -0.0, aux[0])
    aux[1] = torch.where(torch.from_numpy(rng.random(n_pad) < 0.5).to(card), -1.0, 1.0)
    got, want = _keep2_pair(form, (comp, aux), q, cls, keep)
    _same_bits(got, want, 2 * keep)
    assert (got[0] == 0).all() and torch.signbit(got[0]).any()
    assert (~torch.signbit(got[0])).any()
    if keep == 2:
        assert torch.signbit(got[2]).any()


@pytest.mark.parametrize("keep", [1, 2])
@pytest.mark.parametrize("form", _KEEP2_FORMS)
@pytest.mark.parametrize("dp", [400, 912])
def test_keep2_kernel_wide_widths(card, form, dp, keep):
    """Column-chunked members on the narrow 64-query tile: dp = 400 (two
    chunks) and dp = 912 (four), each with a narrower last chunk."""
    rng = np.random.default_rng(dp + len(form))
    tables, q = _keep2_inputs(rng, form, 2048, dp, 150, card)
    got, want = _keep2_pair(form, tables, q, 256, keep)
    _same_bits(got, want, 2 * keep)


@pytest.mark.parametrize("keep", [1, 2])
@pytest.mark.parametrize("form", _KEEP2_FORMS)
def test_keep2_kernel_launches_agree(card, form, keep):
    """Two launches on the same inputs give the same bits."""
    rng = np.random.default_rng(23)
    tables, q = _keep2_inputs(rng, form, 8192, 144, 300, card)
    got, want = _keep2_pair(form, tables, q, 512, keep)
    again, _ = _keep2_pair(form, tables, q, 512, keep)
    _same_bits(got, again, 2 * keep)
    _same_bits(got, want, 2 * keep)

# --- the routed class-max scan (K4) --------------------------------------------

def _k4_tables(rng, d, comp_dtype, dev, T, G, P, integer=True, C=9, cap=512, cls=256):
    """Clustered split tables of C clusters (some slots empty) plus the pad
    cluster C on ``dev``, G*T bf16 queries and a (G, P) column table whose
    first row names the pad cluster and whose last row names it P-1 times
    (a group with one granted cluster). Integer rows as ``_k3_tables``."""
    from shine_tpu_torch.models.routed_split import pack_clustered
    from shine_tpu_torch.ops.scan_split import pack_split_query

    n = C * cap - 100
    if integer:
        v = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
        v[:, 0] = np.where(rng.random(n) < 0.5, -127.0, 127.0)
        q = rng.integers(-4, 5, size=(G * T, d)).astype(np.float32)
    else:
        v = rng.normal(size=(n, d)).astype(np.float32)
        q = rng.normal(size=(G * T, d)).astype(np.float32)
    gid = np.full((C + 1) * cap, -1, np.int32)
    gid[np.sort(rng.choice(C * cap, n, replace=False))] = rng.permutation(n)
    comp, aux_r = pack_clustered(torch.from_numpy(v).to(dev), torch.from_numpy(gid).to(dev),
                                 0, cap=cap, cls=cls, comp_dtype=comp_dtype)
    cols = np.stack([rng.choice(C + 1, P, replace=False) for _ in range(G)]).astype(np.int32)
    cols[0, 0] = C
    cols[-1] = C
    cols[-1, rng.integers(0, P)] = rng.integers(0, C)
    q = pack_split_query(torch.from_numpy(q).to(dev), comp.shape[1])
    return comp, aux_r, q, torch.from_numpy(cols).to(dev), cap, cls


@pytest.mark.parametrize("d", [16, 128, 960])
@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("T", [16, 32, 64])
def test_routed_kernel_integers_bit_for_bit(card, d, comp_dtype, T):
    """Exact integer scores: K4 equals its twin bit for bit, ties, pad
    rows, the pad cluster and a group with one granted cluster included."""
    from shine_tpu_torch.ops.scan_routed import routed_classmax_scan, routed_classmax_scan_ref

    rng = np.random.default_rng(d + T)
    comp, aux_r, q, cols, cap, cls = _k4_tables(rng, d, comp_dtype, card, T, G=5, P=4)
    before = routed_classmax_scan.launches
    form = (comp_dtype, T)
    form_before = routed_classmax_scan.form_launches.get(form, 0)
    got = routed_classmax_scan(comp, aux_r, q, cols, T=T, cap=cap, cls=cls)
    torch.cuda.synchronize()
    assert routed_classmax_scan.launches == before + 1
    assert routed_classmax_scan.form_launches[form] == form_before + 1
    want = routed_classmax_scan_ref(comp, aux_r, q, cols, T=T, cap=cap, cls=cls)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("T", [48, 8])
def test_routed_kernel_ragged_groups(card, T):
    """Groups that fill a 64- or 32-query tile only in part: each group's
    rows are written from its own columns and no other group's rows are
    touched; comp carries ingest-pad rows past the clusters."""
    from shine_tpu_torch.ops.scan_routed import routed_classmax_scan, routed_classmax_scan_ref

    rng = np.random.default_rng(T)
    comp, aux_r, q, cols, cap, cls = _k4_tables(rng, 128, "int8", card, T, G=3, P=5)
    comp = torch.cat([comp, torch.full((2 * cap, comp.shape[1]), 7, dtype=comp.dtype,
                                       device=card)])
    got = routed_classmax_scan(comp, aux_r, q, cols, T=T, cap=cap, cls=cls)
    want = routed_classmax_scan_ref(comp, aux_r, q, cols, T=T, cap=cap, cls=cls)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
def test_routed_kernel_gaussian(card, comp_dtype):
    from shine_tpu_torch.ops.scan_routed import routed_classmax_scan, routed_classmax_scan_ref

    rng = np.random.default_rng(5)
    comp, aux_r, q, cols, cap, cls = _k4_tables(rng, 128, comp_dtype, card, 64, G=6, P=6,
                                                integer=False)
    best, rows = routed_classmax_scan(comp, aux_r, q, cols, T=64, cap=cap, cls=cls)
    want_b, want_r = routed_classmax_scan_ref(comp, aux_r, q, cols, T=64, cap=cap, cls=cls)
    torch.testing.assert_close(best, want_b, rtol=0, atol=K2_ATOL)
    assert (rows == want_r).float().mean() > 0.99


def test_routed_empty_batch_launches_nothing(card):
    from shine_tpu_torch.ops.scan_routed import routed_classmax_scan

    comp = torch.zeros(2 * 512, 32, dtype=torch.int8, device=card)
    aux_r = torch.ones(2, 4, 256, device=card)
    aux_r[1, :2] = -3e38  # cluster 1 is the pad cluster
    q = torch.zeros(0, 32, dtype=torch.bfloat16, device=card)
    cols = torch.zeros(0, 3, dtype=torch.int32, device=card)
    before = routed_classmax_scan.launches
    got = routed_classmax_scan(comp, aux_r, q, cols, T=16, cap=512, cls=256)
    assert routed_classmax_scan.launches == before
    assert all(g.shape == (0, 256) and g.is_cuda for g in got)


@pytest.mark.parametrize("bad", ["none", "width", "wide", "cls", "T", "cols_range",
                                 "cols_dtype", "aux_shape", "dtype", "unaligned",
                                 "cpu_cols", "pad_row"])
def test_routed_kernel_rejects_what_it_cannot_take(card, bad):
    from shine_tpu_torch.ops.scan_routed import routed_classmax_scan

    C, cap, cls, T, G = 3, 512, 256, 16, 2
    comp = torch.zeros((C + 1) * cap, 32, dtype=torch.int8, device=card)
    aux_r = torch.ones(C + 1, 4, cls, device=card)
    aux_r[C, :2] = -3e38  # the pad cluster
    q = torch.zeros(G * T, 32, dtype=torch.bfloat16, device=card)
    cols = torch.zeros(G, 3, dtype=torch.int32, device=card)
    if bad == "none":  # the inputs above are good: the kernel runs
        routed_classmax_scan(comp, aux_r, q, cols, T=T, cap=cap, cls=cls)
        return
    if bad == "width":
        comp, q = comp[:, :24].contiguous(), q[:, :24].contiguous()
    elif bad == "wide":
        comp = torch.zeros((C + 1) * cap, 1296, dtype=torch.int8, device=card)
        q = torch.zeros(G * T, 1296, dtype=torch.bfloat16, device=card)
    elif bad == "cls":
        cls, aux_r = 32, torch.full((C + 1, 32, 32), -3e38, device=card)
    elif bad == "T":
        T, q = 128, torch.zeros(G * 128, 32, dtype=torch.bfloat16, device=card)
    elif bad == "cols_range":
        cols[1, 2] = C + 1
    elif bad == "cols_dtype":
        cols = cols.long()
    elif bad == "aux_shape":
        aux_r = aux_r[:, :2].contiguous()
    elif bad == "dtype":
        comp = comp.half()
    elif bad == "unaligned":
        comp = torch.zeros((C + 1) * cap * 32 + 8, dtype=torch.int8,
                           device=card)[8:].view(-1, 32)
    elif bad == "cpu_cols":
        cols = cols.cpu()
    elif bad == "pad_row":
        comp[C * cap + 7, 3] = 1
    with pytest.raises((TypeError, ValueError)):
        routed_classmax_scan(comp, aux_r, q, cols, T=T, cap=cap, cls=cls)


def _k4_pair(comp, aux_r, q, cols, T, cap, cls):
    """(kernel, twin) outputs of K4; the kernel's launch counts by one, in
    all and in its form."""
    from shine_tpu_torch.ops.scan_routed import routed_classmax_scan, routed_classmax_scan_ref

    form = ("int8" if comp.dtype == torch.int8 else "bf16", T)
    before = routed_classmax_scan.launches
    form_before = routed_classmax_scan.form_launches.get(form, 0)
    got = routed_classmax_scan(comp, aux_r, q, cols, T=T, cap=cap, cls=cls)
    torch.cuda.synchronize()
    assert routed_classmax_scan.launches == before + 1
    assert routed_classmax_scan.form_launches[form] == form_before + 1
    return got, routed_classmax_scan_ref(comp, aux_r, q, cols, T=T, cap=cap, cls=cls)


@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("T", [16, 64])
def test_routed_kernel_all_scores_equal(card, comp_dtype, T):
    """Every real row scores the same: each lane's winner is member 0 of the
    group's first real column, the earliest code."""
    rng = np.random.default_rng(41 + T)
    C, cap, cls, G, P = 6, 512, 256, 3, 4
    comp, aux_r, q, cols, _, _ = _k4_tables(rng, 64, comp_dtype, card, T, G, P, C=C,
                                            cap=cap, cls=cls)
    comp[:C * cap] = comp[0]
    aux_r[:C, : cap // cls] = 3.0  # one nrm and one scl for every row
    aux_r[:C, cap // cls:] = 2.0
    cols[:-1] = torch.from_numpy(np.stack([rng.choice(C, P, replace=False)
                                           for _ in range(G - 1)]).astype(np.int32)).to(card)
    cols[0, 0] = C  # the first column a pad column
    got, want = _k4_pair(comp, aux_r, q, cols, T, cap, cls)
    _same_bits(got, want, 2)
    first = torch.tensor([int(next(p for p in range(P) if int(cols[g, p]) < C))
                          for g in range(G)], device=card)
    lane = torch.arange(cls, dtype=torch.int32, device=card)
    expect = (first.repeat_interleave(T)[:, None] * (cap // cls) * cls + lane).to(torch.int32)
    assert torch.equal(got[1], expect)


@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
def test_routed_kernel_signed_zero_ties(card, comp_dtype):
    """Zero rows whose nrm is +0.0 or -0.0 and whose scl is +-1 score +0.0
    and -0.0, which tie: the earliest code wins with its own sign. Every
    other row scores below -8000."""
    rng = np.random.default_rng(43)
    C, cap, cls, T, G, P = 6, 512, 256, 32, 3, 5
    comp, aux_r, q, cols, _, _ = _k4_tables(rng, 32, comp_dtype, card, T, G, P, C=C,
                                            cap=cap, cls=cls)
    mc = cap // cls
    zero = torch.from_numpy(rng.random((C, mc, cls)) < 0.5).to(card)
    zero[:, 0] = True  # member 0 of every cluster: each class has a zero score
    comp3 = comp[:C * cap].view(C, mc, cls, -1)
    comp3[zero] = 0
    nrm = torch.where(zero, 0.0, -1e4)
    sign = torch.from_numpy(rng.random((C, mc, cls)) < 0.5).to(card)
    aux_r[:C, :mc] = torch.where(zero & sign, -0.0, nrm)
    aux_r[:C, mc:] = torch.where(torch.from_numpy(rng.random((C, mc, cls)) < 0.5).to(card),
                                 -1.0, 1.0)
    got, want = _k4_pair(comp, aux_r, q, cols, T, cap, cls)
    _same_bits(got, want, 2)
    assert bool((cols < C).any(1).all())  # every group holds zeros
    assert (got[0] == 0).all()
    assert torch.signbit(got[0]).any() and (~torch.signbit(got[0])).any()


@pytest.mark.parametrize("comp_dtype", ["bf16", "int8"])
def test_routed_kernel_group_of_pad_columns(card, comp_dtype):
    """A group whose columns all name the pad cluster walks nothing and
    keeps the start state: -3e38 and code 0 on every lane; its neighbours
    are untouched by it."""
    rng = np.random.default_rng(47)
    C, cap, cls, T, G, P = 5, 512, 256, 16, 4, 3
    comp, aux_r, q, cols, _, _ = _k4_tables(rng, 128, comp_dtype, card, T, G, P, C=C,
                                            cap=cap, cls=cls)
    cols[1] = C
    got, want = _k4_pair(comp, aux_r, q, cols, T, cap, cls)
    _same_bits(got, want, 2)
    lane = torch.arange(cls, dtype=torch.int32, device=card)
    assert (got[0][T:2 * T] == -3e38).all()
    assert torch.equal(got[1][T:2 * T], lane.expand(T, cls))
    assert (got[0][2 * T:] > -3e38).any()


def test_routed_index_on_card_matches_cpu(card):
    from shine_tpu_torch import RoutedSplitIndex, build_routed_split
    from shine_tpu_torch.ops.scan_routed import routed_classmax_scan

    ds = synthetic_dataset(n=20_000, dim=32, num_queries=300, seed=6, compute_gt=False)
    cpu = build_routed_split(20_000, 32, base_dev=torch.from_numpy(ds.base),
                             cap_target=512, cls=128, train_size=8192, seed=3)
    gpu = RoutedSplitIndex(*(t.to(card) for t in (cpu.centroids, cpu.comp, cpu.aux_r,
                                                   cpu.gid)),
                           cpu.n, cpu.dim, cpu.metric, cls=cpu.cls, cap=cpu.cap,
                           base_dev=cpu.base_dev.to(card), sqnorms=cpu.sqnorms.to(card))
    for knobs in ({}, {"probes": 8, "tile": 32, "shared": 16},
                  {"probes": 8, "tile": 64, "shared": 10, "fallback": 0.6}):
        a, da = cpu.search(ds.queries, 10, batch_size=128, **knobs)
        before = routed_classmax_scan.launches
        b, db = gpu.search(ds.queries, 10, batch_size=128, **knobs)
        assert routed_classmax_scan.launches > before
        assert gpu.last_fallback == cpu.last_fallback
        assert (a == b).mean() >= 0.99
        same = a == b
        np.testing.assert_allclose(db[same], da[same], rtol=RTOL, atol=ATOL)
    # the build itself on the card
    built = build_routed_split(20_000, 32, base_dev=torch.from_numpy(ds.base).to(card),
                               cap_target=512, cls=128, train_size=8192, seed=3)
    assert built.comp.is_cuda and built.C == cpu.C
    ids, _ = built.search(ds.queries, 10, batch_size=128)
    assert (ids >= 0).all()


def test_ivf_index_on_card_matches_cpu(card):
    """IVFIndex (no kernel of its own: torch products) on the card against
    the same layout on the CPU: search, search_routed with a spill, and the
    build itself on the card."""
    from shine_tpu_torch import IVFIndex
    from shine_tpu_torch.models.ivf import IVFData

    ds = synthetic_dataset(n=6000, dim=32, num_queries=200, seed=13, compute_gt=False)
    cpu = IVFIndex(ds.base, num_clusters=64, seed=7, device="cpu")
    gpu = IVFIndex.from_layout(IVFData(*(t.to(card) for t in cpu.data)), "l2")
    for run in (lambda ix: ix.search(ds.queries, 10, probes=8),
                lambda ix: ix.search_routed(ds.queries, 10, probes=8, shared=48, tile=32),
                lambda ix: ix.search_routed(ds.queries, 10, probes=8, shared=4, tile=64)):
        (a, da), (b, db) = run(cpu), run(gpu)
        same = a == b
        assert same.mean() >= 0.99
        np.testing.assert_allclose(db[same], da[same], rtol=RTOL, atol=ATOL)
    # the builds themselves on the card
    for built in (IVFIndex(ds.base, num_clusters=64, seed=7, device=card),
                  IVFIndex.from_device(torch.from_numpy(ds.base).to(card),
                                       num_clusters=64, seed=7, device=card)):
        ids = built.data.block_ids
        assert built.data.blocks.is_cuda
        assert torch.equal(torch.sort(ids[ids >= 0]).values.cpu(),
                           torch.arange(6000, dtype=ids.dtype))
        assert (built.search(ds.queries, 10, probes=8)[0] >= 0).all()


# --- K5 and K6: the block-max scans ------------------------------------------

def _int_table(rng, n, n_pad, d, metric, dev, B=200):
    """Packed table of integer rows (ties inside and across blocks; rows past
    n are pad rows) and integer queries: every score is exact in f32."""
    from shine_tpu_torch.ops.scan import pack_ext_query, pack_ext_table

    v = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    v[40:48] = v[39]
    v[300] = v[2]
    q = rng.integers(-3, 4, size=(B, d)).astype(np.float32)
    ext = pack_ext_table(v, metric, n_pad, device=dev)
    q_ext = pack_ext_query(torch.from_numpy(q).to(dev), ext.shape[1])
    return ext, q_ext.to(torch.bfloat16)


@pytest.mark.parametrize("d", [16, 128, 960])
@pytest.mark.parametrize("metric", [0, 1])
def test_blockmax_kernels_integers_bit_for_bit(card, d, metric):
    """K5 and K6 equal their twins bit for bit on integer tables, pad rows,
    an all-pad tail, in-block ties and a ragged batch included."""
    from shine_tpu_torch.ops import blockmax as bm

    rng = np.random.default_rng(d + 7 * metric)
    ext, q = _int_table(rng, 9000, 16384, d, metric, card, B=77)
    for fn, ref in ((bm.blockmax_scan, bm.blockmax_scan_ref),
                    (bm.blockmax_scan2, bm.blockmax_scan2_ref)):
        before = fn.launches
        got = fn(ext, q)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        want = ref(ext, q)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("d", [16, 128, 960])
def test_blockmax_kernels_gaussian(card, d):
    from shine_tpu_torch.ops import blockmax as bm

    rng = np.random.default_rng(11 * d)
    ext, q = _k2_case(rng, 16384, d, 256, card, pad_rows=1000)
    m1, a1, m2, a2 = bm.blockmax_scan(ext, q)
    w1, wa1, w2, wa2 = bm.blockmax_scan_ref(ext, q)
    torch.testing.assert_close(m1, w1, rtol=0, atol=K2_ATOL)
    torch.testing.assert_close(m2, w2, rtol=0, atol=K2_ATOL)
    clear = (w1 - w2) > K2_ATOL  # the winner is unambiguous
    assert clear[w2 > -3e38].float().mean() > 0.5  # of the blocks with real rows
    assert torch.equal(a1[clear], wa1[clear])
    c1, r1 = bm.blockmax_scan2(ext, q)
    v1, s1 = bm.blockmax_scan2_ref(ext, q)
    torch.testing.assert_close(c1, v1, rtol=0, atol=K2_ATOL)
    assert (r1 == s1).float().mean() > 0.99


@pytest.mark.parametrize("chunks,B", [(1, 300), (2, 129), (245, 1100), (300, 1100)])
def test_blockmax2_kernel_chunk_runs_bit_for_bit(card, chunks, B):
    """K6 over 1, 2, 245 and 300 chunks of 4096 rows: a CTA walks a run of
    chunks (5 or 6 at B = 1100), restarts at each and writes each chunk's
    classes; bit for bit against the twin on integer rows, pad rows in the
    last chunk."""
    from shine_tpu_torch.ops import blockmax as bm

    n_pad = chunks * bm.TN
    rng = np.random.default_rng(chunks)
    ext, q = _int_table(rng, n_pad - 700, n_pad, 32, chunks % 2, card, B=B)
    before = bm.blockmax_scan2.launches
    got = bm.blockmax_scan2(ext, q)
    torch.cuda.synchronize()
    assert bm.blockmax_scan2.launches == before + 1
    _same_bits(got, bm.blockmax_scan2_ref(ext, q), 2)


def test_blockmax_empty_batch_launches_nothing(card):
    from shine_tpu_torch.ops import blockmax as bm

    ext = torch.zeros(4096, 32, dtype=torch.bfloat16, device=card)
    q = torch.zeros(0, 32, dtype=torch.bfloat16, device=card)
    for fn, width in ((bm.blockmax_scan, 32), (bm.blockmax_scan2, 128)):
        before = fn.launches
        got = fn(ext, q)
        assert fn.launches == before
        assert all(g.shape == (0, width) and g.is_cuda for g in got)


@pytest.mark.parametrize("bad", ["width", "wide", "rows", "dtype", "cpu_q",
                                 "unaligned", "strided"])
def test_blockmax_kernels_reject_what_they_cannot_take(card, bad):
    from shine_tpu_torch.ops import blockmax as bm

    ext = torch.zeros(8192, 32, dtype=torch.bfloat16, device=card)
    q = torch.zeros(8, 32, dtype=torch.bfloat16, device=card)
    if bad == "width":
        ext, q = ext[:, :24].contiguous(), q[:, :24].contiguous()
    elif bad == "wide":
        ext = torch.zeros(4096, 1328, dtype=torch.bfloat16, device=card)
        q = torch.zeros(8, 1328, dtype=torch.bfloat16, device=card)
    elif bad == "rows":
        ext = ext[:4000]
    elif bad == "dtype":
        ext = ext.half()
    elif bad == "cpu_q":
        q = q.cpu()
    elif bad == "unaligned":
        ext = torch.zeros(8192 * 32 + 4, dtype=torch.bfloat16,
                          device=card)[4:].view(8192, 32)
    elif bad == "strided":
        ext = torch.zeros(8192, 64, dtype=torch.bfloat16, device=card)[:, :32]
    for fn in (bm.blockmax_scan, bm.blockmax_scan2):
        with pytest.raises((TypeError, ValueError)):
            fn(ext, q)


# --- K5's edges (the block walk of csrc/classmax2_scan.cu) ----------------------

def _k5_inputs(rng, n_pad, dp, B, dev, real=None):
    """Integer bf16 rows and queries (every score exact in f32); rows from
    ``real`` on are pad rows, which score bf16(-3e38) through the last
    column, as a packed table's pad rows do."""
    v = rng.integers(-3, 4, size=(n_pad, dp)).astype(np.float32)
    q = rng.integers(-3, 4, size=(B, dp)).astype(np.float32)
    v[:, -1] = 0.0
    q[:, -1] = 1.0
    if real is not None:
        v[real:] = 0.0
        v[real:, -1] = -3e38
    return (torch.from_numpy(v).to(dev).to(torch.bfloat16),
            torch.from_numpy(q).to(dev).to(torch.bfloat16))


def _k5_pair(ext, q):
    from shine_tpu_torch.ops import blockmax as bm

    before = bm.blockmax_scan.launches
    got = bm.blockmax_scan(ext, q)
    torch.cuda.synchronize()
    assert bm.blockmax_scan.launches == before + 1
    return got, bm.blockmax_scan_ref(ext, q)


# (n_pad, dp, B, real rows): one block; 37 blocks (runs of 16 end part-way);
# 1300 blocks over 17 query tiles (CTAs of 22 blocks, two writes each, the
# last CTA 2 blocks); B = 1, 65, 129, 257 (three query tiles, an odd count);
# pad blocks; wide tables (64-query tile, column chunks)
_K5_EDGES = {
    "one_block": (128, 144, 100, None),
    "ragged_run": (37 * 128, 144, 200, None),
    "long_runs": (1300 * 128, 32, 2100, None),
    "B1": (4096, 144, 1, None),
    "B65": (4096, 144, 65, None),
    "B129": (4096, 144, 129, None),
    "B257": (4096, 144, 257, None),
    "pad_blocks": (8192, 144, 150, 3000),
    "dp400": (4096, 400, 150, 4000),
    "dp912": (4096, 912, 150, 4000),
    "dp1312": (2048, 1312, 70, 2000),
}


@pytest.mark.parametrize("case", sorted(_K5_EDGES))
def test_blockmax_kernel_edges_bit_for_bit(card, case):
    n_pad, dp, B, real = _K5_EDGES[case]
    rng = np.random.default_rng(len(case) + dp)
    ext, q = _k5_inputs(rng, n_pad, dp, B, card, real)
    got, want = _k5_pair(ext, q)
    _same_bits(got, want)
    if real is not None and real // 128 + 1 < n_pad // 128:
        # a block of pad rows only: (-3e38, arg1) by the mask rule
        pad = slice(real // 128 + 1, None)
        assert (got[2][:, pad] == -3e38).all() and torch.equal(got[3][:, pad], got[1][:, pad])


def test_blockmax_kernel_all_scores_equal(card):
    """A block whose rows all score the same: the winner is its first row
    and the runner-up the next one."""
    rng = np.random.default_rng(31)
    ext, q = _k5_inputs(rng, 4096, 144, 90, card)
    ext[640:768] = ext[640]  # block 5
    got, want = _k5_pair(ext, q)
    _same_bits(got, want)
    assert (got[1][:, 5] == 640).all() and (got[3][:, 5] == 641).all()
    assert torch.equal(got[0][:, 5], got[2][:, 5])


def test_blockmax_kernel_signed_zero_ties(card):
    """Rows of +0.0 and of -0.0 score zeros that tie across the two 64-row
    halves of a block, every other row scores below: the lowest zero row
    wins and the next zero row is the runner-up, as in the twin (the
    values equal as numbers; their sign is the sum order's)."""
    rng = np.random.default_rng(37)
    n_pad, dp, B = 4096, 64, 80
    ext = torch.full((n_pad, dp), -1.0, dtype=torch.bfloat16, device=card)
    q = torch.from_numpy(rng.integers(1, 4, size=(B, dp)).astype(np.float32)).to(
        card).to(torch.bfloat16)
    zero_rows = []
    for blk in range(n_pad // 128):
        a, b = blk * 128 + int(rng.integers(0, 64)), blk * 128 + 64 + int(rng.integers(0, 64))
        ext[a] = -0.0 if blk % 2 else 0.0
        ext[b] = 0.0 if blk % 2 else -0.0
        zero_rows.append((a, b))
    got, want = _k5_pair(ext, q)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)
    a, b = (torch.tensor(r, dtype=torch.int32, device=card) for r in zip(*zero_rows))
    assert (got[0] == 0).all() and (got[2] == 0).all()
    assert torch.equal(got[1], a.expand(B, -1)) and torch.equal(got[3], b.expand(B, -1))


# --- ROADMAP C9: the routed build's sums are the same on every run ------------

def test_routed_build_sums_are_deterministic_on_the_card(card):
    """Two runs of each k-means helper and of recenter_routing on the card,
    same inputs and seed: bit-identical centroids and assignments."""
    from shine_tpu_torch import build_routed_split
    from shine_tpu_torch.models import ivf
    from shine_tpu_torch.parallel import placement

    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(65_536, 64)).astype(np.float32)).to(card)

    def twice(fn):
        a, b = fn(), fn()
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(u, v)
        return a

    cents = twice(lambda: ivf._lloyd_chunked(x, k=300, iters=8, seed=5))
    twice(lambda: placement._lloyd(cents, k=24, iters=15, seed=5))
    twice(lambda: ivf._lloyd_balance_refine(x, cents, k=300, rounds=2))
    ds = synthetic_dataset(n=65_536, dim=32, num_queries=8, seed=4, compute_gt=False)
    base = torch.from_numpy(ds.base).to(card)
    built = [build_routed_split(65_536, 32, base_dev=base, cap_target=512, cls=128,
                                train_size=16_384, seed=3) for _ in range(2)]
    assert torch.equal(built[0].gid, built[1].gid)
    assert torch.equal(built[0].centroids, built[1].centroids)

    def recentred():
        built[0].recenter_routing(chunk=8192)
        return built[0].centroids.clone()

    twice(recentred)


# --- the fused beam step (K1's beam_step) --------------------------------------


@pytest.fixture(scope="module")
def step_graph():
    ds = synthetic_dataset(n=3000, dim=32, num_queries=64, seed=8,
                           compute_gt=False)
    return ds, build_graph(ds.base, HNSWParams(M=8, ef_construction=64),
                           threads=1)


def _step_start(g, queries, sp, l2, dev):
    """(q_ext, bias, state): the seeded layer-0 state of ``queries``."""
    q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(dev)
    q_ext, bias = th._extend_query(q, 0 if l2 else 1)
    seed_ids, seed_d, _ = th._seeds(g, q_ext, bias, sp, l2)
    return q_ext, bias, list(th._l0_state(seed_ids, seed_d, sp))


def _clone(state):
    beam, *rest = state
    return [Beam(*(c.clone() for c in beam))] + [x.clone() for x in rest]


def _assert_same_state(a, b):
    (ba, *ra), (bb, *rb) = a, b
    assert torch.equal(ba.dists.view(torch.int32), bb.dists.view(torch.int32))
    assert torch.equal(ba.ids, bb.ids)
    assert torch.equal(ba.expanded, bb.expanded)
    for x, y in zip(ra, rb):
        assert torch.equal(x, y)


def _step(fn, g, q_ext, bias, state, t, sp, l2, vectors=None, neighbors0=None):
    beam, hops, counts, uns = state
    fn(g.vectors_ext if vectors is None else vectors,
       g.neighbors0 if neighbors0 is None else neighbors0, q_ext, bias, beam,
       hops, counts, uns, t, frontier=sp.frontier, k=sp.k, term=sp.term, l2=l2,
       row_scl=g.row_scl, row_nrm=g.row_nrm)


def _both_until_settled(g, q_ext, bias, state, sp, l2, **tables):
    """The kernel and the plain step side by side from ``state``, equal bit
    for bit after every step; returns the steps run."""
    fused, plain = state, _clone(state)
    for t in range(sp.max_steps):
        before = bs.beam_step.launches
        _step(bs.beam_step, g, q_ext, bias, fused, t, sp, l2, **tables)
        assert bs.beam_step.launches == before + 1
        _step(bs.beam_step_ref, g, q_ext, bias, plain, t, sp, l2, **tables)
        torch.cuda.synchronize()
        _assert_same_state(fused, plain)
        if int(fused[3][t + 1]) == 0:
            return t + 1
    return sp.max_steps


@pytest.mark.parametrize("frontier,ef", [(f, e) for f in (1, 4, 8) for e in (16, 48, 96)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("rows", ["f32", "bf16", "int8"])
def test_beam_step_matches_plain_over_whole_searches(card, step_graph, rows, metric,
                                                     frontier, ef):
    ds, graph = step_graph
    g = th.device_graph(graph, rows=rows, device=card)
    l2 = metric == "l2"
    for term in ("ef", "k"):
        sp = SearchParams(k=min(10, ef), ef=ef, frontier=frontier,
                          term=term).resolved()
        q_ext, bias, state = _step_start(g, ds.queries, sp, l2, card)
        steps = _both_until_settled(g, q_ext, bias, state, sp, l2)
        assert steps > 1


def _int_graph(card, n=600, d=16, distinct=None, seed=0):
    """A DeviceGraph of integer f32 rows (every distance exact) and random
    lists of width 16; ``distinct`` rows repeat a few vectors (equal
    distances on different ids)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(-3, 4, size=(distinct or n, d)).astype(np.float32)
    v = pool[rng.integers(0, len(pool), size=n)] if distinct else pool
    nb = rng.integers(0, n, size=(n, 16)).astype(np.int32)
    upper = np.arange(0, n, 7, dtype=np.int32)
    return th.DeviceGraph(
        vectors_ext=torch.from_numpy(v).to(card),
        neighbors0=torch.from_numpy(nb).to(card),
        upper_row=torch.full((n,), -1, dtype=torch.int32, device=card),
        upper_neighbors=torch.zeros((1, 1, 1), dtype=torch.int32, device=card),
        upper_ids=torch.from_numpy(upper).to(card),
        upper_vecs_ext=torch.from_numpy(v[upper]).to(card),
        entry_point=0, top_level=0)


_STEP_EDGES = ("expanded", "inactive", "padded_lists", "shared_ids", "ties",
               "signed_zero", "gated")


@pytest.mark.parametrize("case", _STEP_EDGES)
def test_beam_step_edges_bit_for_bit(card, case):
    rng = np.random.default_rng(len(case))
    g = _int_graph(card, distinct=5 if case == "ties" else None)
    B, d = 48, g.vectors_ext.shape[1]
    queries = rng.integers(-3, 4, size=(B, d)).astype(np.float32)
    l2 = case != "signed_zero"
    sp = SearchParams(k=4, ef=16, frontier=4, entry_seeds=6).resolved()
    q_ext, bias, state = _step_start(g, queries, sp, l2, card)
    tables = {}
    beam = state[0]
    if case == "expanded":  # half the queries have nothing left to expand
        beam.expanded[: B // 2] = True
    elif case == "inactive":  # fewer unexpanded entries than frontier slots
        beam.expanded[:, 1:] = True
    elif case == "padded_lists":
        nb = g.neighbors0.clone()
        nb[torch.rand(nb.shape, device=card) < 0.6] = -1
        nb[::3] = -1  # whole lists of pads
        tables["neighbors0"] = nb
    elif case == "shared_ids":  # every list drawn from 12 ids: repeats across lists
        tables["neighbors0"] = torch.from_numpy(rng.choice(
            12, size=g.neighbors0.shape).astype(np.int32)).to(card)
    elif case == "signed_zero":  # IP, zero query and bias: every score is +0.0
        q_ext.zero_()
        bias.zero_()
        sign = torch.where(torch.rand(beam.dists.shape, device=card) < 0.5, -1.0, 1.0)
        real = beam.ids >= 0
        beam.dists.copy_(torch.where(real, sign * 0.0, beam.dists))
        order = torch.argsort(torch.where(real, beam.ids, 2**31 - 1), dim=1)
        for c in beam:  # re-sorted by id, as beam_merge leaves equal keys
            c.copy_(torch.gather(c, 1, order))
    elif case == "gated":
        state[3][0] = 0
        before = _clone(state)
        n = bs.beam_step.launches
        _step(bs.beam_step, g, q_ext, bias, state, 0, sp, l2)
        torch.cuda.synchronize()
        assert bs.beam_step.launches == n + 1
        _assert_same_state(state, before)
        state[3][0] = 1
    steps = _both_until_settled(g, q_ext, bias, state, sp, l2, **tables)
    assert steps >= 1
    if case == "signed_zero":
        ids = state[0].ids
        real = ids >= 0
        assert (state[0].dists[real] == 0).all()
        assert (torch.where(real[:, 1:], ids[:, 1:], 2**31 - 1) > ids[:, :-1]).all()


def test_beam_step_gated_launches_change_nothing_in_a_search(card, step_graph):
    """A search that reads the count back every 4 (and every 7) launches
    equals the one that reads it after every launch, bit for bit; the extra
    launches are gated no-ops."""
    ds, graph = step_graph
    g = th.device_graph(graph, rows="f32", device=card)
    q = torch.from_numpy(ds.queries).to(card)
    q_ext, bias = th._extend_query(q, 0)
    sp = SearchParams(k=10, ef=48, frontier=4).resolved()
    seed_ids, seed_d, _ = th._seeds(g, q_ext, bias, sp, True)
    out = []
    for every in (1, 4, 7):
        before = bs.beam_step.launches
        beam, hops, counts, steps = th._beam_search_l0_seeded(
            g, q_ext, bias, seed_ids, seed_d, sp, check_every=every)
        launches = bs.beam_step.launches - before
        assert steps <= launches < steps + every
        out.append((beam, hops, counts, steps))
    for beam, hops, counts, steps in out[1:]:
        _assert_same_state([beam, hops, counts], [out[0][0], out[0][1], out[0][2]])
        assert steps == out[0][3]


@pytest.mark.parametrize("rows", ["f32", "bf16", "int8"])
def test_beam_step_scores_are_gather_score_bits(card, step_graph, rows):
    """The rows a fused step brings into the beam carry the bits that the
    standalone gather_score gives them; gather_score's bits do not depend
    on a row's lane."""
    ds, graph = step_graph
    g = th.device_graph(graph, rows=rows, device=card)
    sp = SearchParams(k=10, ef=48, frontier=8).resolved()
    q_ext, bias, state = _step_start(g, ds.queries, sp, True, card)
    old_ids = state[0].ids.clone()
    _step(bs.beam_step, g, q_ext, bias, state, 0, sp, True)
    beam = state[0]
    new = (beam.ids >= 0) & ~(beam.ids[:, :, None] == old_ids[:, None, :]).any(-1)
    assert new.sum() > 0
    ids = torch.where(new, beam.ids, -1)
    kw = dict(row_scl=g.row_scl, row_nrm=g.row_nrm, l2=True)
    got = gather_score(g.vectors_ext, q_ext, bias, ids, **kw)
    assert torch.equal(got[new].view(torch.int32), beam.dists[new].view(torch.int32))
    perm = torch.randperm(ids.shape[1], device=card)
    moved = gather_score(g.vectors_ext, q_ext, bias, ids[:, perm].contiguous(), **kw)
    assert torch.equal(moved.view(torch.int32), got[:, perm].view(torch.int32))


@pytest.mark.parametrize("bad", ["ef", "lanes", "smem", "t", "k", "term", "cpu_q",
                                 "hops_dtype", "beam_shape"])
def test_beam_step_rejects_what_it_cannot_take(card, bad):
    rng = np.random.default_rng(3)
    n, d, B, ef, W, E = 200, 16, 4, 16, 16, 4
    if bad == "smem":
        d = 12_000  # a 48,000-byte query row leaves too little for the rest
    if bad == "ef":
        ef = bs.MAX_EF + 1
    if bad == "lanes":
        E = bs.MAX_LANES // W + 1
    vectors = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(card)
    nb = torch.from_numpy(rng.integers(0, n, size=(n, W)).astype(np.int32)).to(card)
    q_ext = torch.zeros((B, d), device=card)
    bias = torch.zeros(B, device=card)
    beam = th.beam_init(B, ef, card)
    hops = torch.zeros(B, dtype=torch.int32, device=card)
    counts = torch.zeros(B, dtype=torch.int32, device=card)
    uns = torch.ones(4, dtype=torch.int32, device=card)
    t, k, term = 0, 4, "ef"
    if bad == "t":
        t = 3
    elif bad == "k":
        k = ef + 1
    elif bad == "term":
        term = "all"
    elif bad == "cpu_q":
        q_ext = q_ext.cpu()
    elif bad == "hops_dtype":
        hops = hops.long()
    elif bad == "beam_shape":
        beam = th.beam_init(B, ef + 1, card)._replace(ids=beam.ids)
    before = bs.beam_step.launches
    with pytest.raises((ValueError, TypeError)):
        bs.beam_step(vectors, nb, q_ext, bias, beam, hops, counts, uns, t,
                     frontier=E, k=k, term=term)
    assert bs.beam_step.launches == before


# --- the insert build's searches (models/build.py) ----------------------------


@pytest.fixture(scope="module")
def build_state():
    """(Gaussian rows, a build state on the card after the rows' first 1025
    inserts, the next batch's ids), built once for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from shine_tpu_torch.models import build as tb

    ds = synthetic_dataset(n=4000, dim=32, num_queries=1, seed=9, compute_gt=False)
    st = tb.init_build_state(ds.base, HNSWParams(M=8, ef_construction=64),
                             device="cuda")
    for lo in range(1, 1025, 256):
        tb.insert_round(st, np.arange(lo, lo + 256, dtype=np.int32), ef=64,
                        frontier=4, max_add=16, metric=0, B_up=40)
    return ds, st, np.arange(1025, 1281, dtype=np.int32)


@pytest.mark.parametrize("level", [0, 1])
def test_build_search_is_beam_step_bit_for_bit(card, build_state, level):
    """A round's search on layer 0 (neighbors0) and on level 1 (its list
    table by id), seeded as the round seeds it: beam_step against
    beam_step_ref bit for bit after every step, ef=64, frontier=4."""
    from types import SimpleNamespace

    from shine_tpu_torch.models import build as tb

    _, st, ids = build_state
    q_ext, bias = tb._query_ext(st, torch.from_numpy(ids).long().to(card), True)
    target = torch.full((len(ids),), level, dtype=torch.int32, device=card)
    ep, ep_d = tb._greedy_to_level(st, q_ext, bias, target, True)
    if level == 0:
        lists = st.neighbors0[: st.n]
    else:
        every = torch.arange(st.n, dtype=torch.int32, device=card)
        lists = tb._neighbors_at(st, every, 0).contiguous()
    g = SimpleNamespace(vectors_ext=st.vectors, neighbors0=lists, row_scl=None,
                        row_nrm=None)
    sp = SearchParams(k=64, ef=64, frontier=4, max_steps=2 * 16 + 8)
    state = list(th._l0_state(ep[:, None].contiguous(), ep_d[:, None].contiguous(), sp))
    steps = _both_until_settled(g, q_ext, bias, state, sp, True)
    assert steps > 2
    before = bs.beam_step.launches
    beam = tb._search_level(st, q_ext, bias, ep, ep_d, level, 64, 4, True)
    assert bs.beam_step.launches > before
    _assert_same_state([beam], [state[0]])


def test_integer_device_build_equal_on_cpu_and_card(card):
    """Integer rows (every distance exact): device_build_graph and the online
    index build the same graph from the twins and from the kernels, and the
    card's build launches both K1 kernels."""
    from shine_tpu_torch.models.build import device_build_graph
    from shine_tpu_torch.models.dynamic import DynamicHNSWIndex

    rows = np.random.default_rng(12).integers(-4, 5, size=(3000, 16)).astype(np.float32)
    p = HNSWParams(M=8, ef_construction=40)
    cpu = device_build_graph(rows, p, device="cpu", batch_size=256, first_batch=16)
    before = (bs.beam_step.launches, gather_score.launches)
    gpu = device_build_graph(rows, p, device=card, batch_size=256, first_batch=16)
    assert bs.beam_step.launches > before[0] and gather_score.launches > before[1]
    fields = ("levels", "neighbors0", "upper_row", "upper_neighbors")
    for f in fields:
        np.testing.assert_array_equal(getattr(gpu, f), getattr(cpu, f), err_msg=f)
    assert (gpu.entry_point, gpu.top_level) == (cpu.entry_point, cpu.top_level)
    online = [DynamicHNSWIndex(16, 3000, p, batch_size=256, device=dev)
              for dev in ("cpu", card)]
    for lo, hi in ((0, 1000), (1000, 3000)):
        for index in online:
            index.add(rows[lo:hi])
        a, b = (index.snapshot() for index in online)
        for f in fields:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)


def test_device_build_refuses_ef_above_the_kernel_limit(card, monkeypatch):
    """ef_construction above beam_step's MAX_EF raises on the card instead of
    running the plain step."""
    from shine_tpu_torch.models.build import device_build_graph

    def no_twin(*args, **kwargs):
        raise AssertionError("the plain step ran for CUDA tensors")

    monkeypatch.setattr(bs, "beam_step_ref", no_twin)
    rows = np.random.default_rng(13).normal(size=(300, 16)).astype(np.float32)
    before = bs.beam_step.launches
    with pytest.raises(ValueError, match=str(bs.MAX_EF)):
        device_build_graph(rows, HNSWParams(M=8, ef_construction=bs.MAX_EF + 1),
                           device=card)
    assert bs.beam_step.launches == before


# --- the row-keyed capacity path: regen_rows and regen_score ----------------

def _row_source(card, d, nc=64, seed=17):
    from shine_tpu_torch.ops import threefry as tf

    k0, k1 = tf.split(tf.prng_key(seed), 2)
    return k1, (tf.normal(k0, (nc, d)) * 4.0).to(card)


@pytest.mark.parametrize("d", [16, 128, 960])
@pytest.mark.parametrize("normalize", [False, True])
def test_regen_rows_kernel_bit_for_bit(card, d, normalize):
    from shine_tpu_torch.ops import regen

    key, centers = _row_source(card, d)
    ids = torch.randint(0, 2**31 - 1, (5000,), generator=torch.Generator().manual_seed(d))
    ids[:3] = torch.tensor([0, 1, 2**31 - 1])
    before = regen.regen_rows.launches
    got = regen.regen_rows(key, centers, ids.to(card), normalize=normalize)
    torch.cuda.synchronize()
    assert regen.regen_rows.launches == before + 1
    want = regen.regen_rows_ref(key, centers, ids.to(card), normalize=normalize)
    assert torch.equal(got, want)
    # the CPU's log1p rounds otherwise than the card's: a few ulps, no more
    cpu = regen.regen_rows_ref(key, centers.cpu(), ids, normalize=normalize)
    torch.testing.assert_close(got.cpu(), cpu, rtol=0, atol=4e-6 * (1 if normalize else 32))


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("metric", [0, 1])
def test_regen_score_kernel_bit_for_bit(card, d, metric):
    from shine_tpu_torch.ops import regen

    key, centers = _row_source(card, d)
    rng = np.random.default_rng(d + metric)
    B, K = 300, 80
    cand = rng.integers(0, 1 << 30, size=(B, K)).astype(np.int32)
    cand[rng.random((B, K)) < 0.1] = -1
    rows = regen.regen_rows(key, centers, torch.from_numpy(cand[:, 0]).clamp_min(0).to(card),
                            normalize=metric == 1)
    q = (rows + 0.3 * torch.randn(rows.shape, generator=torch.Generator(card).manual_seed(1),
                                  device=card)).contiguous()
    cand_t = torch.from_numpy(cand).to(card)
    before = regen.regen_score.launches
    got = regen.regen_score(key, centers, q, cand_t, metric)
    torch.cuda.synchronize()
    assert regen.regen_score.launches == before + 1
    assert torch.equal(got, regen.regen_score_ref(key, centers, q, cand_t, metric))
    assert torch.equal(torch.isinf(got), cand_t < 0)
    # one query's scores are the same bits in a batch of one
    assert torch.equal(regen.regen_score(key, centers, q[7:8].contiguous(),
                                         cand_t[7:8].contiguous(), metric), got[7:8])


def test_regen_kernels_reject_what_they_cannot_take(card):
    from shine_tpu_torch.ops import regen

    key, centers = _row_source(card, 16)
    q = torch.zeros(2, 16, device=card)
    with pytest.raises(ValueError):  # queries on another device
        regen.regen_score(key, centers, q.cpu(), torch.zeros(2, 3, dtype=torch.int32,
                                                              device=card), 0)
    with pytest.raises(TypeError):  # int64 candidates
        regen.regen_score(key, centers, q, torch.zeros(2, 3, dtype=torch.int64, device=card), 0)
    with pytest.raises(TypeError):
        regen.regen_rows(key, centers.double(), torch.arange(3, device=card))
    assert regen.regen_rows(key, centers, torch.zeros(0, dtype=torch.int64,
                                                      device=card)).shape == (0, 16)


# --- ROADMAP C11: one query, one answer at any batch size ----------------------

C11_BATCHES = (64, 2048, 16_384)


def _c11_batch(q64: np.ndarray, filler: np.ndarray, B: int) -> np.ndarray:
    return np.ascontiguousarray(np.concatenate([q64, filler[:B - len(q64)]]))


def _c11_same(results, what: str) -> None:
    (i0, d0), *rest = results
    for (i, dd), B in zip(rest, C11_BATCHES[1:]):
        assert np.array_equal(i, i0), f"{what}: ids differ at batch {B}"
        assert np.array_equal(np.asarray(dd, np.float32).view(np.uint32),
                              np.asarray(d0, np.float32).view(np.uint32)), (
            f"{what}: distance bits differ at batch {B}")


@pytest.fixture(scope="module")
def c11_set():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return synthetic_dataset(n=65_536, dim=32, num_queries=C11_BATCHES[-1], seed=12,
                             compute_gt=False)


@pytest.mark.parametrize("family", ["fastflat", "split_int8", "ivf", "hnsw"])
def test_c11_one_query_one_answer_at_any_batch(card, c11_set, family):
    """64 queries served inside batches of 64, 2,048 and 16,384: the same
    ids and the same distance bits."""
    from shine_tpu_torch import FastFlatIndex, IVFIndex, SplitFlatIndex

    ds = c11_set
    q64, filler = ds.queries[:64], ds.queries[64:]
    if family == "fastflat":
        idx = FastFlatIndex(ds.base, device=card)
        run = lambda q, B: idx.search(q, 10, batch_size=B)  # noqa: E731
    elif family == "split_int8":
        idx = SplitFlatIndex(ds.base, comp_dtype="int8", device=card)
        run = lambda q, B: idx.search(q, 10, batch_size=B)  # noqa: E731
    elif family == "ivf":
        idx = IVFIndex(ds.base, num_clusters=256, seed=7, device=card)
        run = lambda q, B: idx.search(q, 10, probes=16, batch_size=B)  # noqa: E731
    else:
        graph = build_graph(ds.base, HNSWParams(M=8, ef_construction=64), threads=8)
        idx = HNSWIndex(graph, device=card)
        run = lambda q, B: idx.search(q, SearchParams(k=10, ef=64), batch_size=B)  # noqa: E731
    results = []
    for B in C11_BATCHES:
        ids, dd = run(_c11_batch(q64, filler, B), B)
        results.append((ids[:64], dd[:64]))
    _c11_same(results, family)


def test_c11_routed_one_query_one_answer_at_any_batch(card, c11_set):
    """The routed family grants clusters to tiles, so a query's grant
    follows its tile-mates: each query here fills its own T=16 tile (16
    copies), the set is 4 queries x 16, and its results must not change
    with the batch around it (64, 2,048, 16,384 queries)."""
    from shine_tpu_torch import build_routed_split

    ds = c11_set
    base = torch.from_numpy(ds.base).to(card)
    idx = build_routed_split(65_536, 32, base_dev=base, cap_target=512, cls=128, seed=3)
    rep = np.repeat(ds.queries, 16, axis=0)
    q64, filler = rep[:64], rep[64:]
    results = []
    for B in C11_BATCHES:
        ids, dd = idx.search(_c11_batch(q64, filler, B), 10, probes=8, tile=16, shared=8,
                             batch_size=B, fallback=0)
        results.append((ids[:64], dd[:64]))
        assert idx.last_coverage == 1.0
    _c11_same(results, "routed")


# --- the sharded search, its shards stacked on the card ----------------------


@pytest.fixture(scope="module")
def sharded_set():
    ds = synthetic_dataset(n=20_000, dim=64, num_queries=256, seed=13)
    return ds, build_graph(ds.base, HNSWParams(M=16, ef_construction=100),
                           threads=1)


def _sharded(graph, S, dev, *, kw=None, spkw=None, queries, batch=128):
    from shine_tpu_torch.parallel import ShardedIndex, shard_mesh

    idx = ShardedIndex(graph, shard_mesh(S, device=dev), **(kw or {}))
    before = gather_score.launches
    ids, dd = idx.search(queries, SearchParams(k=10, ef=64, frontier=4,
                                               **(spkw or {})), batch_size=batch)
    return ids, dd, gather_score.launches - before, idx


def test_sharded_one_answer_across_shards_and_exchanges(card, sharded_set):
    """S = 1, 2, 4 and 8 with the dense and the compact exchange (and the
    compact one starved into overflow rounds): equal ids and distance bits
    on Gaussian rows, every distance scored by K1."""
    ds, graph = sharded_set
    ref_i, ref_d, launches, _ = _sharded(graph, 1, card, queries=ds.queries)
    assert launches > 0
    for S in (1, 2, 4, 8):
        for spkw in ({}, {"exchange": "compact"},
                     {"exchange": "compact", "exchange_slack": 0.25}):
            ids, dd, launches, idx = _sharded(graph, S, card, spkw=spkw,
                                              queries=ds.queries)
            assert launches > 0, (S, spkw)
            np.testing.assert_array_equal(ids, ref_i, err_msg=f"{S} {spkw}")
            np.testing.assert_array_equal(dd.view(np.int32), ref_d.view(np.int32),
                                          err_msg=f"{S} {spkw}")
            if spkw and S > 1:
                assert idx.rpc_rounds > 0


@pytest.mark.parametrize("kw,spkw", [
    ({"cache_capacity": 2000}, {}),
    ({"cache_capacity": 2000, "adaptive_cache": True, "refresh_every": 1},
     {"exchange": "compact"}),
    ({"routing": True}, {}),
    ({"routing": "adaptive", "cache_capacity": 1000}, {"exchange": "compact"}),
    ({"rows": "bf16"}, {"entry_mode": "descent"}),
])
def test_sharded_cache_and_routing_change_no_bit(card, sharded_set, kw, spkw):
    ds, graph = sharded_set
    rows = kw.get("rows", "f32")
    ref_i, ref_d, _, _ = _sharded(graph, 4, card, kw={"rows": rows},
                                  spkw={k: v for k, v in spkw.items()
                                        if k == "entry_mode"},
                                  queries=ds.queries)
    ids, dd, launches, idx = _sharded(graph, 4, card, kw=kw, spkw=spkw,
                                      queries=ds.queries)
    assert launches > 0
    np.testing.assert_array_equal(ids, ref_i)
    np.testing.assert_array_equal(dd.view(np.int32), ref_d.view(np.int32))
    if "cache_capacity" in kw:
        assert idx.cache_hits > 0


def test_sharded_card_mesh_equals_cpu_mesh_on_integer_rows(card):
    rng = np.random.default_rng(21)
    base = rng.integers(-8, 9, size=(8192, 16)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(200, 16)).astype(np.float32)
    graph = build_graph(base, HNSWParams(M=8, ef_construction=64), threads=1)
    kw = {"cache_capacity": 500, "routing": True}
    for spkw in ({}, {"exchange": "compact"}):
        gi, gd, launches, gidx = _sharded(graph, 8, card, kw=kw, spkw=spkw,
                                          queries=queries)
        ci, cd, cpu_launches, cidx = _sharded(graph, 8, "cpu", kw=kw, spkw=spkw,
                                              queries=queries)
        assert launches > 0 and cpu_launches == 0
        np.testing.assert_array_equal(gi, ci)
        np.testing.assert_array_equal(gd.view(np.int32), cd.view(np.int32))
        for c in ("last_hops", "cache_hits", "cache_misses", "rpc_rounds",
                  "ici_lanes", "ici_bytes"):
            assert getattr(gidx, c) == getattr(cidx, c), c


# --- the sharded scan families, their shards stacked on the card -------------

SCAN_S = 4


def _sharded_scans(base, mesh, layouts=None):
    """(name, run(q, B) -> (ids, dists), index) for each sharded scan family
    on ``mesh``, built from the same host rows. The IVF layout and the
    routed index come from ``layouts`` (built once on the CPU: k-means on
    the card sums in another order and may cluster otherwise), else are
    built on the mesh's first device."""
    from shine_tpu_torch import build_routed_split
    from shine_tpu_torch.models.ivf import build_ivf_layout
    from shine_tpu_torch.parallel import (
        ShardedFastFlatIndex,
        ShardedIVFIndex,
        ShardedRoutedSplitIndex,
        ShardedSplitFlatIndex,
    )

    n, d = base.shape
    if layouts is None:
        dev = mesh.devices[0]
        layouts = (build_ivf_layout(base, 256, seed=7, device=dev),
                   build_routed_split(n, d, base_dev=torch.from_numpy(base).to(dev),
                                      cap_target=512, cls=128, seed=3, shards=SCAN_S))
    layout, single = layouts
    fast = ShardedFastFlatIndex(base, mesh, seed=1)
    split = ShardedSplitFlatIndex.from_host(base, mesh, comp_dtype="int8", seed=1)
    ivf = ShardedIVFIndex.from_parts(mesh, layout.centroids, layout.blocks,
                                     layout.block_sq, layout.block_ids, base)
    routed = ShardedRoutedSplitIndex.from_single(single, mesh)
    return {
        "fastflat": (lambda q, B: fast.search(q, 10, batch_size=B), fast),
        "fastflat_keep2": (lambda q, B: fast.search(q, 10, kb=32, keep2=True,
                                                    batch_size=B), fast),
        "split_int8": (lambda q, B: split.search(q, 10, batch_size=B), split),
        "ivf_compact": (lambda q, B: ivf.search(q, 10, probes=16, batch_size=B), ivf),
        "ivf_dense": (lambda q, B: ivf.search(q, 10, probes=16, batch_size=B,
                                              probe_lanes="dense"), ivf),
        "ivf_routed": (lambda q, B: ivf.search_routed(q, 10, probes=8, shared=16,
                                                      tile=32, batch_size=B), ivf),
        "routed": (lambda q, B: routed.search(q, 10, probes=8, shared=16, tile=32,
                                              batch_size=B), routed),
    }


SCAN_COUNTERS = ("rpc_rounds", "scanned_lanes", "last_coverage", "last_overflow",
                 "last_lanes", "last_fallback")


@pytest.mark.parametrize("family", ["fastflat", "fastflat_keep2", "split_int8",
                                    "ivf_compact", "ivf_dense", "ivf_routed", "routed"])
def test_sharded_scans_card_mesh_equals_cpu_mesh(card, family):
    """Integer rows (every sum exact): each sharded scan family on a mesh of
    4 shards stacked on the card gives the CPU mesh's ids, distance bits and
    counters (the IVF layout and the routed index built once, on the CPU)."""
    from shine_tpu_torch.parallel import shard_mesh

    rng = np.random.default_rng(33)
    base = rng.integers(-8, 9, size=(65_536, 16)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(256, 16)).astype(np.float32)
    from shine_tpu_torch import build_routed_split
    from shine_tpu_torch.models.ivf import build_ivf_layout

    layouts = (build_ivf_layout(base, 256, seed=7, device="cpu"),
               build_routed_split(65_536, 16, base_dev=torch.from_numpy(base),
                                  cap_target=512, cls=128, seed=3, shards=SCAN_S))
    got = {}
    for where in (card, "cpu"):
        run, idx = _sharded_scans(base, shard_mesh(SCAN_S, device=where),
                                  layouts)[family]
        got[str(where)] = (*run(queries, 128),
                           {c: getattr(idx, c) for c in SCAN_COUNTERS if hasattr(idx, c)})
    (gi, gd, gc), (ci, cd, cc) = got[str(card)], got["cpu"]
    np.testing.assert_array_equal(gi, ci)
    np.testing.assert_array_equal(gd.view(np.int32), cd.view(np.int32))
    assert gc == cc


def test_sharded_scan_kernels_at_per_shard_shapes(card):
    """Every K2 and K3 form at the shapes a shard of the 1M sets gives them
    (253,952 and 262,144 rows, d=128) and K4 at 270 clusters with 98 lanes
    a group: the kernels equal their twins bit for bit on integer rows."""
    from shine_tpu_torch.ops import classmax as cm
    from shine_tpu_torch.ops.scan_routed import routed_classmax_scan, routed_classmax_scan_ref

    rng = np.random.default_rng(5)
    ext = torch.from_numpy(rng.integers(-4, 5, size=(253_952, 144)).astype(
        np.float32)).to(card).to(torch.bfloat16)
    q = torch.from_numpy(rng.integers(-4, 5, size=(512, 144)).astype(
        np.float32)).to(card).to(torch.bfloat16)
    for fn, ref, kw in ((cm.classmax_scan, cm.classmax_scan_ref, {}),
                        (cm.classmax2_scan, cm.classmax2_scan_ref, {}),
                        (cm.classmax_topk_scan, cm.classmax_topk_scan_ref, {"kb": 16}),
                        (cm.classmax2_topk_scan, cm.classmax2_topk_scan_ref, {"kb": 32})):
        for g, w in zip(fn(ext, q, cls=2048, **kw), ref(ext, q, cls=2048, **kw)):
            assert torch.equal(g, w), fn.__name__
    del ext
    for comp_dtype in ("int8", "bf16"):
        comp, aux, qs = _k3_tables(rng, 262_144, 128, 512, comp_dtype, card)
        for fn in _K3_FNS:
            for keep2 in (False, True):
                _, run = _k3_call(fn, keep2, cls=2048, kb=32)
                _, twin = _k3_call(fn, keep2, ref=True, cls=2048, kb=32)
                for g, w in zip(run(comp, aux, qs), twin(comp, aux, qs)):
                    assert torch.equal(g, w), (comp_dtype, fn, keep2)
    comp, aux_r, q, cols, cap, cls = _k4_tables(rng, 128, "int8", card, 64, G=4, P=98,
                                                C=269, cap=1024, cls=256)
    for g, w in zip(routed_classmax_scan(comp, aux_r, q, cols, T=64, cap=cap, cls=cls),
                    routed_classmax_scan_ref(comp, aux_r, q, cols, T=64, cap=cap, cls=cls)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("family", ["fastflat", "split_int8", "ivf_compact"])
def test_c11_sharded_one_query_one_answer_at_any_batch(card, c11_set, family):
    """ROADMAP C11 on a mesh of 4 shards stacked on the card: 64 queries
    inside batches of 64, 2,048 and 16,384 keep their ids and distance bits
    (the IVF re-rank runs on the host in numpy)."""
    from shine_tpu_torch.parallel import shard_mesh

    ds = c11_set
    run, _ = _sharded_scans(ds.base, shard_mesh(SCAN_S, device=card))[family]
    q64, filler = ds.queries[:64], ds.queries[64:]
    results = []
    for B in C11_BATCHES:
        ids, dd = run(_c11_batch(q64, filler, B), B)
        results.append((ids[:64], dd[:64]))
    _c11_same(results, f"sharded {family}")
