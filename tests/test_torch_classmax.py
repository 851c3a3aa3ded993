"""The class-max scan (shine_tpu_torch.ops.classmax, K2) and its packed table
(shine_tpu_torch.ops.scan) against shine_tpu.ops.pallas_scan3 and
shine_tpu.ops.pallas_scan, the Pallas kernels run in interpret mode as
tests/test_pallas.py runs them. On the CPU the port's wrappers run their
plain twins; the CUDA kernel is held against the twins in
tests/test_torch_kernel.py, on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shine_tpu.ops import pallas_scan as jscan
from shine_tpu.ops import pallas_scan3 as j3
from shine_tpu_torch.ops import classmax as cm
from shine_tpu_torch.ops import scan as tscan

N, B = 8192, 128
# Gaussian scores sum <= 32 bf16 products (each exact in f32) of O(1)
# magnitude in another order: they differ by a few f32 ulps of ~10
GAUSS_ATOL = 1e-4

_FORMS = {
    "classmax_scan": (j3.classmax_scan, cm.classmax_scan, False),
    "classmax2_scan": (j3.classmax2_scan, cm.classmax2_scan, False),
    "classmax_topk_scan": (j3.classmax_topk_scan, cm.classmax_topk_scan, True),
    "classmax2_topk_scan": (j3.classmax2_topk_scan, cm.classmax2_topk_scan, True),
}


def _tables(rng, n, dp, integer, pad_rows=0):
    """(ext (n, dp), q (B, dp)) as f32 numpy holding bf16-exact values. Pad
    rows look like the packed table's: zero, NEG in the last column, which
    every query multiplies by 1."""
    if integer:
        ext = rng.integers(-4, 5, size=(n, dp)).astype(np.float32)
        q = rng.integers(-4, 5, size=(B, dp)).astype(np.float32)
    else:
        ext = rng.normal(size=(n, dp)).astype(np.float32)
        q = rng.normal(size=(B, dp)).astype(np.float32)
    ext = np.array(jnp.asarray(ext, jnp.bfloat16).astype(jnp.float32))
    q = np.array(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    if pad_rows:
        ext[n - pad_rows:] = 0.0
        ext[n - pad_rows:, -1] = tscan.NEG
        q[:, -1] = 1.0
    return ext, q


def _run_both(form, ext, q, cls, kb):
    jfn, tfn, topk = _FORMS[form]
    kw = {"cls": cls, **({"kb": kb} if topk else {})}
    want = jfn(jnp.asarray(ext, jnp.bfloat16), jnp.asarray(q, jnp.bfloat16),
               tq=B, tn=max(2048, cls), interpret=True, **kw)
    got = tfn(torch.from_numpy(ext).to(torch.bfloat16),
              torch.from_numpy(q).to(torch.bfloat16), **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("form", list(_FORMS))
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("cls,kb", [(256, 8), (1024, 32)])
def test_twins_match_pallas_bit_for_bit_on_integers(form, d, cls, kb):
    """Integer rows and queries in [-4, 4]: every score is an exact f32
    integer and ties are frequent, so both tie rules (earliest row in a
    class, lower lane in the select) and keep2's demotion rule show."""
    ext, q = _tables(np.random.default_rng(d + cls), N, d, integer=True)
    want, got = _run_both(form, ext, q, cls, kb)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g, w)
    # ties really occur: many classes hold a best score more than once
    assert (want[0][:, :, None] == want[0][:, None, :]).sum() > B * want[0].shape[1]


@pytest.mark.parametrize("form", list(_FORMS))
def test_pad_rows_and_empty_classes_bit_for_bit(form):
    """Rows past the real ones hold NEG: they never enter, and a class with
    no real row keeps the start state (NEG, row = lane), as in Pallas."""
    cls, kb = 1024, 32
    ext, q = _tables(np.random.default_rng(5), 2048, 16, integer=True,
                     pad_rows=2048 - 700)
    want, got = _run_both(form, ext, q, cls, kb)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    if form == "classmax_scan":
        assert (got[0][:, 700:] == np.float32(tscan.NEG)).all()
        np.testing.assert_array_equal(got[1][:, 700:],
                                      np.broadcast_to(np.arange(700, cls), (B, cls - 700)))


@pytest.mark.parametrize("form", list(_FORMS))
@pytest.mark.parametrize("d", [16, 32])
def test_twins_match_pallas_on_gaussians(form, d):
    """Gaussian rows: scores agree to GAUSS_ATOL; rows agree wherever the
    class winner beats its runner-up by more than that."""
    cls, kb = 256, 32
    ext, q = _tables(np.random.default_rng(100 + d), N, d, integer=False)
    want, got = _run_both(form, ext, q, cls, kb)
    for w, g in zip(want[::2], got[::2]):
        np.testing.assert_allclose(g, w, rtol=0, atol=GAUSS_ATOL)
    if form == "classmax2_scan":
        clear = (want[0] - want[2]) > GAUSS_ATOL
        assert clear.mean() > 0.99
        np.testing.assert_array_equal(got[1][clear], want[1][clear])


@pytest.mark.parametrize("keep2", [False, True])
def test_fused_forms_equal_unfused_plus_select(keep2):
    rng = np.random.default_rng(9)
    ext, q = _tables(rng, N, 32, integer=True)
    e, qq = torch.from_numpy(ext).to(torch.bfloat16), torch.from_numpy(q).to(torch.bfloat16)
    unfused = (cm.classmax2_scan if keep2 else cm.classmax_scan)(e, qq, cls=512)
    fused = (cm.classmax2_topk_scan if keep2 else cm.classmax_topk_scan)(
        e, qq, cls=512, kb=24)
    vals, sel = cm.select_lanes(unfused[0], 24)
    assert torch.equal(fused[0], vals)
    for f, u in zip(fused[1:], unfused[1:]):
        assert torch.equal(f, torch.gather(u, 1, sel))


@pytest.mark.parametrize("k", [1, 7, 40])
def test_select_lanes_ties_like_lax_top_k(k):
    best = np.random.default_rng(k).integers(-3, 3, size=(16, 64)).astype(np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(best), k)
    got_v, got_i = cm.select_lanes(torch.from_numpy(best), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_select_lanes_signed_zeros_tie():
    """-0.0 and +0.0 tie and the lower lane goes first, as in the Pallas
    epilogue's float compare (lax.top_k would put +0.0 first)."""
    best = torch.tensor([[0.0, -0.0, 1.0, -0.0, 0.0]])
    _, lanes = cm.select_lanes(best, 5)
    assert lanes.tolist() == [[2, 0, 1, 3, 4]]


def test_cpu_runs_twins_and_counts_no_launch():
    ext, q = _tables(np.random.default_rng(1), 4096, 16, integer=True)
    e, qq = torch.from_numpy(ext).to(torch.bfloat16), torch.from_numpy(q).to(torch.bfloat16)
    before = {name: f.launches for name, (_, f, _) in _FORMS.items()}
    got = cm.classmax_scan(e, qq, cls=256)
    want = cm.classmax_scan_ref(e, qq, cls=256)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    cm.classmax2_topk_scan(e, qq, cls=256, kb=4)
    assert before == {name: f.launches for name, (_, f, _) in _FORMS.items()}


@pytest.mark.parametrize("form", list(_FORMS))
def test_empty_batch_gives_empty_planes_and_no_launch(form):
    _, fn, topk = _FORMS[form]
    e = torch.zeros(2048, 32, dtype=torch.bfloat16)
    q = torch.zeros(0, 32, dtype=torch.bfloat16)
    kw = {"cls": 256, **({"kb": 8} if topk else {})}
    before = fn.launches
    got = fn(e, q, **kw)
    assert fn.launches == before
    assert len(got) == (4 if "2" in form else 2)
    assert all(g.shape == (0, 8 if topk else 256) for g in got)
    assert [g.dtype for g in got[:2]] == [torch.float32, torch.int32]


@pytest.mark.parametrize("bad", ["f32_table", "width", "rows_per_class",
                                 "kb_zero", "kb_over", "strided", "meta"])
def test_wrappers_reject(bad):
    e = torch.zeros(2048, 32, dtype=torch.bfloat16)
    q = torch.zeros(4, 32, dtype=torch.bfloat16)
    kw = {"cls": 256}
    fn = cm.classmax_scan
    if bad == "f32_table":
        e = e.float()
    elif bad == "width":
        q = torch.zeros(4, 48, dtype=torch.bfloat16)
    elif bad == "rows_per_class":
        kw = {"cls": 3000}
    elif bad in ("kb_zero", "kb_over"):
        fn, kw = cm.classmax_topk_scan, {"cls": 256, "kb": 0 if bad == "kb_zero" else 257}
    elif bad == "strided":
        q = torch.zeros(32, 4, dtype=torch.bfloat16).T
    elif bad == "meta":
        e, q = e.to("meta"), q.to("meta")
    with pytest.raises((TypeError, ValueError)):
        fn(e, q, **kw)


@pytest.mark.parametrize("metric", [0, 1])
@pytest.mark.parametrize("n,d", [(5000, 16), (4096, 30), (300, 128)])
def test_pack_ext_table_matches_jax_bit_for_bit(metric, n, d):
    v = (np.random.default_rng(n + d).normal(size=(n, d)) * 3).astype(np.float32)
    n_pad = -(-n // tscan.QUANTUM) * tscan.QUANTUM
    want = jnp.asarray(jscan.pack_ext_table(v, metric, n_pad), jnp.bfloat16)
    want = np.asarray(want).view(np.uint16)
    got = tscan.pack_ext_table(v, metric, n_pad)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (n_pad, tscan.ext_width(d))
    assert got.shape[1] % 16 == 0 and got.shape[1] >= d + 2
    bits = got.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(bits[:, : d + 2], want[:, : d + 2])
    assert not bits[:, d + 2:].any()


@pytest.mark.parametrize("metric", [0, 1])
def test_pack_ext_device_matches_host_pack(metric):
    v = (np.random.default_rng(4).normal(size=(4096, 24)) * 3).astype(np.float32)
    host = tscan.pack_ext_table(v, metric, 4096).float()
    dev = tscan.pack_ext_device(torch.from_numpy(v), metric).float()
    assert torch.equal(dev[:, :24], host[:, :24])
    # the norm pair: torch's and numpy's f32 row sums may differ in an ulp,
    # which can move c0's rounding; the pair carries ~16 bits either way
    torch.testing.assert_close(dev[:, 24] + dev[:, 25], host[:, 24] + host[:, 25],
                               rtol=2.0**-15, atol=0)


@pytest.mark.parametrize("d", [16, 30])
def test_pack_ext_query_matches_jax(d):
    q = np.random.default_rng(d).normal(size=(9, d)).astype(np.float32)
    want = np.asarray(jscan.pack_ext_query(q, 128))
    got = tscan.pack_ext_query(torch.from_numpy(q), tscan.ext_width(d)).numpy()
    np.testing.assert_array_equal(got[:, : d + 2], want[:, : d + 2])
    assert not got[:, d + 2:].any()
