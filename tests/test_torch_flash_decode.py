"""Decode attention (``flash_decode``) through its plain PyTorch version.

``repro_torch.kernels.ops.flash_decode`` on CPU tensors takes the plain
version of the kernel; these tests hold it against ``repro``'s Pallas
kernel (interpret mode) and ``repro.kernels.ref.flash_decode`` at the
shapes of the reference's own kernel test, with that test's tolerances:
rtol = atol = 2e-4 in f32 and 2e-2 in bf16 (both packages round the same
f32 numbers to bf16 and compute in f32).  ``kv_len = 0`` gives zeros, as
the Pallas kernel does (``ref`` gives NaN there: it masks with ``-inf``).
The CUDA kernel is held against the same plain version on the card by
``chip_smoke.py``; a last test routes meta tensors through the wrapper to
show that a tensor off the CPU reaches the kernel binding only.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# (b, h, hkv, d, s): tests/kernels/test_kernels.py's shapes (the last MQA)
SHAPES = [(2, 8, 2, 64, 300), (1, 4, 4, 32, 128), (3, 16, 4, 128, 1000),
          (1, 8, 1, 64, 256)]
TOL = {"f32": 2e-4, "bf16": 2e-2}


def _inputs(seed, b, h, hkv, d, s):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32) * 0.3
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    kvl = rng.integers(1, s + 1, size=b).astype(np.int32)
    return q, k, v, kvl


def _both(arrays, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("b,h,hkv,d,s", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_decode_matches_reference(b, h, hkv, d, s, dtype):
    q, k, v, kvl = _inputs(b * 1000 + s, b, h, hkv, d, s)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    got = ops.flash_decode(tq, tk, tv, torch.from_numpy(kvl)).numpy()
    assert got.dtype == np.float32 and got.shape == (b, h, d)
    tol = TOL[dtype]
    want_ref = np.stack([np.asarray(jref.flash_decode(
        jq[i], jk[i], jv[i], int(kvl[i]))) for i in range(b)])
    np.testing.assert_allclose(got, want_ref, rtol=tol, atol=tol)
    want_kernel = np.asarray(jops.flash_decode(
        jq, jk, jv, jnp.asarray(kvl), tile_s=128, interpret=True))
    np.testing.assert_allclose(got, want_kernel, rtol=tol, atol=tol)


def test_flash_decode_matches_monoid():
    """The plain version IS the attention combiner: folding KV tiles with
    the (m, l, acc) monoid in float64 gives the same answer (the
    reference's test_flash_decode_matches_monoid)."""
    b, h, hkv, d, s, tile = 1, 2, 1, 16, 64, 16
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    got = ops.flash_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                           torch.tensor([s], dtype=torch.int32),
                           tile_s=tile).numpy()
    scale = 1.0 / np.sqrt(d)
    qf = q[0].astype(np.float64) * scale
    kf = np.repeat(k[0].astype(np.float64), h // hkv, axis=1)
    vf = np.repeat(v[0].astype(np.float64), h // hkv, axis=1)
    m = np.full((h,), -np.inf)
    l = np.zeros((h,))
    acc = np.zeros((h, d))
    for t0 in range(0, s, tile):
        logits = np.einsum("hd,thd->ht", qf, kf[t0:t0 + tile])
        m_new = np.maximum(m, logits.max(1))
        alpha = np.exp(m - m_new)
        p = np.exp(logits - m_new[:, None])
        l = l * alpha + p.sum(1)
        acc = acc * alpha[:, None] + np.einsum("ht,thd->hd", p,
                                               vf[t0:t0 + tile])
        m = m_new
    np.testing.assert_allclose(got[0], acc / l[:, None], rtol=1e-5,
                               atol=1e-5)


def _kernel_order(q, k, v, kvl, tile, chunk, n_split):
    """csrc/flash_decode.cu's order of operations in float64: each chunk
    folds its tiles of ``tile`` positions into its holder online (m' = max(m,
    tile max), alpha = e^(m - m'), l = l alpha + sum p, acc = acc alpha +
    p.V), a chunk past kv_len keeps the empty holder, and the holders merge
    in split order: m* = max_s m_s, l = sum_s l_s e^(m_s - m*), acc
    likewise."""
    b, h, d = q.shape
    g = h // k.shape[2]
    tq, tk, tv = (torch.from_numpy(a).double() for a in (q, k, v))
    out = torch.empty((b, h, d), dtype=torch.float64)
    for i in range(b):
        ms, ls, accs = [], [], []
        for sp in range(n_split):
            m = torch.full((h,), tfd.NEG_INF, dtype=torch.float64)
            l = torch.zeros((h,), dtype=torch.float64)
            acc = torch.zeros((h, d), dtype=torch.float64)
            hi = min((sp + 1) * chunk, int(kvl[i]))
            for lo in range(sp * chunk, hi, tile):
                t1 = min(lo + tile, hi)
                kk = tk[i, lo:t1].repeat_interleave(g, dim=1)
                vv = tv[i, lo:t1].repeat_interleave(g, dim=1)
                lg = torch.einsum("hd,thd->ht", tq[i] * d ** -0.5, kk)
                m_new = torch.maximum(m, lg.amax(1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(lg - m_new[:, None])
                l = l * alpha + p.sum(1)
                acc = acc * alpha[:, None] + torch.einsum("ht,thd->hd", p, vv)
                m = m_new
            ms.append(m)
            ls.append(l)
            accs.append(acc)
        mstar = torch.stack(ms).amax(0)
        l = torch.zeros((h,), dtype=torch.float64)
        acc = torch.zeros((h, d), dtype=torch.float64)
        for m, ls_, a in zip(ms, ls, accs):
            w = torch.exp(m - mstar)
            l = l + ls_ * w
            acc = acc + a * w[:, None]
        out[i] = acc / l.clamp(min=1e-30)[:, None]
    return out.numpy()


@pytest.mark.parametrize("b,h,hkv,d,s,kv", [
    (2, 8, 2, 32, 1000, (777, 5)), (1, 8, 2, 64, 300, (300,)),
    (2, 16, 4, 64, 520, (0, 519)), (1, 4, 1, 32, 96, (33,))])
def test_split_merge_in_fixed_order_is_the_same_function(b, h, hkv, d, s, kv):
    """The kernel's design on the CPU: per-chunk holders merged in split
    order (csrc/flash_decode.cu) equal the plain version and the Pallas
    kernel, for the chunks ``split_plan`` picks."""
    q, k, v, _ = _inputs(3, b, h, hkv, d, s)
    kvl = np.array(kv, np.int32)
    tile, chunk, n_split = tfd.split_plan(b, h, hkv, s, d, 4, 512)
    assert chunk % tile == 0 and chunk * n_split >= s > chunk * (n_split - 1)
    want = _kernel_order(q, k, v, kvl, tile, chunk, n_split)
    # the same function at other splits and tiles
    for tile_, chunk_ in ((16, 48), (32, 32), (64, 256)):
        np.testing.assert_allclose(
            _kernel_order(q, k, v, kvl, tile_, chunk_, -(-s // chunk_)), want,
            rtol=1e-12, atol=1e-12)
    got = ops.flash_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                           torch.from_numpy(kvl))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    pallas = np.asarray(jops.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kvl),
        tile_s=128, interpret=True))
    np.testing.assert_allclose(want, pallas, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b,h,hkv,d,s,item,tile_s", [
    (1, 8, 2, 64, 8192, 4, 512), (4, 32, 8, 128, 2080, 2, 512),
    (3, 16, 4, 128, 1000, 4, 128), (1, 4, 4, 32, 1, 4, 512),
    (64, 8, 8, 64, 100, 4, 512)])
def test_split_plan_covers_s_and_fills_the_card(b, h, hkv, d, s, item,
                                                tile_s):
    tile, chunk, n_split = tfd.split_plan(b, h, hkv, s, d, item, tile_s)
    assert chunk % tile == 0 and tile <= tfd.TILE
    assert chunk <= max(-(-tile_s // tile) * tile, tile)
    assert chunk * n_split >= s > chunk * (n_split - 1)
    g = h // hkv
    gb = tfd.heads_per_block(g)
    smem = tfd.smem_bytes(gb, d, item, tile)
    assert smem <= tfd.SMEM_PER_BLOCK
    resident = tfd.SMS * min(tfd.SMEM_PER_SM // (smem + tfd.SMEM_RESERVE),
                             tfd.MAX_BLOCKS_PER_SM,
                             tfd.MAX_THREADS_PER_SM // tfd.THREADS)
    groups = b * hkv * -(-g // gb)
    blocks = groups * n_split
    # one wave where the chunk cap allows it, and at least half the card
    assert blocks <= max(resident, groups) or chunk == max(
        -(-tile_s // tile) * tile, tile)
    assert blocks >= min(resident, groups * -(-s // tile)) / 2


def test_kv_len_zero_gives_zeros_as_the_pallas_kernel():
    b, h, hkv, d, s = 2, 4, 2, 16, 40
    q, k, v, _ = _inputs(11, b, h, hkv, d, s)
    kvl = np.array([0, 17], np.int32)
    got = ops.flash_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                           torch.from_numpy(kvl)).numpy()
    pallas = np.asarray(jops.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kvl),
        tile_s=16, interpret=True))
    assert np.array_equal(got[0], np.zeros((h, d), np.float32))
    assert np.array_equal(pallas[0], got[0])
    np.testing.assert_allclose(got[1], pallas[1], rtol=2e-4, atol=2e-4)
    # the unfused reference masks with -inf: NaN at kv_len = 0 (ROADMAP)
    assert np.isnan(np.asarray(jref.flash_decode(
        jnp.asarray(q[0]), jnp.asarray(k[0]), jnp.asarray(v[0]), 0))).all()


def test_shape_checks():
    q = torch.zeros(2, 6, 16)
    k = torch.zeros(2, 10, 4, 16)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_decode(q, k, k, torch.ones(2, dtype=torch.int32))
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_decode(q, k, k, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="tile_s"):
        ops.flash_decode(q, k, k, torch.ones(2, dtype=torch.int32),
                         tile_s=0)


def test_cuda_tensors_reach_the_kernel_only(monkeypatch):
    """A tensor off the CPU goes to the kernel binding (never the plain
    version), after the dtype, contiguity and size checks."""
    calls = []

    def plain(*a, **kw):
        raise AssertionError("the plain version ran on a device tensor")

    def kernel(q, k, v, kv_len, *, tile, chunk, n_split):
        calls.append((q.dtype, tile, chunk, n_split))
        return torch.empty(q.shape, dtype=torch.float32, device="meta")

    monkeypatch.setattr(tfd, "flash_decode_plain", plain)
    monkeypatch.setattr(tfd, "flash_decode_cuda", kernel)
    q = torch.empty((4, 32, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((4, 2080, 8, 128), dtype=torch.bfloat16, device="meta")
    kvl = torch.empty((4,), dtype=torch.int32, device="meta")
    assert ops.flash_decode(q, k, k, kvl).shape == (4, 32, 128)
    assert calls == [(torch.bfloat16, 64, 320, 7)]
    with pytest.raises(TypeError, match="int32"):
        ops.flash_decode(q, k, k, kvl.to(torch.int64))
    with pytest.raises(TypeError, match="one dtype"):
        ops.flash_decode(q.float(), k, k, kvl)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                         k, kvl)
    with pytest.raises(ValueError, match="limits"):
        ops.flash_decode(torch.empty((1, 8, 512), device="meta"),
                         torch.empty((1, 4, 1, 512), device="meta"),
                         torch.empty((1, 4, 1, 512), device="meta"),
                         torch.empty((1,), dtype=torch.int32, device="meta"))
