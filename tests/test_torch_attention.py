"""The port's flash attention and chunked attention against the JAX
package: the plain version (and the wrapper on CPU tensors) against the
Pallas flash kernel in interpret mode (as ``tests/test_kernels.py`` runs
it) and against the jnp oracle ``attention_ref`` at shapes the TPU
kernel refuses; the torch ``chunked_attention`` against the XLA one;
the emitter's attention routes; and -- on a card only -- the CUDA kernel
against its plain version.

Tolerances are the repo's (``scripts/check_kernel_parity.py:69``): 1e-4
of scale in f32, 3e-2 in bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.backend import Backend as JBackend  # noqa: E402
from repro.backend import CompileOptions as JOptions  # noqa: E402
from repro.core import ops as j_ops  # noqa: E402
from repro.core.function import Function as JFunction  # noqa: E402
from repro.kernels import ops as jk  # noqa: E402
from repro.kernels.ref import attention_ref as j_attention_ref  # noqa: E402
from repro.kernels.xla_attention import \
    chunked_attention as j_chunked  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.backend import Backend as TBackend  # noqa: E402
from repro_torch.backend import CompileOptions as TOptions  # noqa: E402
from repro_torch.core import ops as t_ops  # noqa: E402
from repro_torch.core.function import Function as TFunction  # noqa: E402
from repro_torch.devices import as_tensor, to_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as kf  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.xla_attention import chunked_attention  # noqa: E402

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 1e-4),
          "bf16": (BF16, jnp.bfloat16, torch.bfloat16, 3e-2),
          "f16": (np.float16, jnp.float16, torch.float16, 3e-2)}
CPU = torch.device("cpu")

# B, Hq, Hkv, Sq, Skv, Dk, Dv, causal, window, offset: the reference's
# ATTN_CASES (tests/test_kernels.py:44-51) plus decode at 0, 100, 255
ATTN_CASES = [
    (1, 2, 2, 128, 128, 128, 128, True, None, None),
    (2, 4, 2, 256, 256, 128, 128, True, None, None),
    (1, 2, 1, 128, 512, 128, 128, True, None, 384),
    (1, 4, 4, 256, 256, 128, 128, True, 64, None),
    (1, 2, 2, 128, 128, 128, 256, False, None, None),
    (1, 8, 1, 128, 256, 128, 128, True, 100, 128),
    (2, 4, 2, 1, 256, 128, 128, True, None, 0),
    (2, 4, 2, 1, 256, 128, 128, True, None, 100),
    (2, 4, 2, 1, 256, 128, 128, True, None, 255),
]


def _qkv(case, np_dt, seed):
    B, Hq, Hkv, Sq, Skv, Dk, Dv = case[:7]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32).astype(np_dt)
            for s in ((B, Hq, Sq, Dk), (B, Hkv, Skv, Dk), (B, Hkv, Skv, Dv))]


def _close(a, b, tol):
    a = np.asarray(a).astype(np.float64)
    b = np.asarray(b).astype(np.float64)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1.0)
    diff = float(np.abs(a - b).max())
    assert diff <= tol * scale, f"max diff {diff} > {tol * scale}"


def _t(x):
    return as_tensor(x, CPU)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_plain_matches_the_pallas_kernel(case, dt):
    np_dt, j_dt, _, tol = DTYPES[dt]
    causal, window, offset = case[7:]
    q, k, v = _qkv(case, np_dt, seed=sum(case[:7]))
    assert jk.attention_supported(q.shape, k.shape)
    jout = jk.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=None if offset is None else jnp.int32(offset),
        interpret=True)
    off = None if offset is None else torch.tensor(offset, dtype=torch.int32)
    plain = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                    window=window, q_offset=off)
    kernels.reset_counters()
    wrapped = kf.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                 window=window, q_offset=off)
    assert torch.equal(wrapped, plain)
    assert kf.launches == 0          # CPU tensors take the plain version
    assert plain.dtype == _t(q).dtype
    _close(to_numpy(plain.float()),
           np.asarray(jnp.asarray(jout, jnp.float32)), tol)


# shapes the TPU kernel refuses (Dk not 128-aligned, Sq and Skv not
# tileable), no row fully masked
ODD_CASES = [
    (1, 4, 2, 100, 300, 64, 128, True, None, 200),
    (2, 2, 1, 100, 300, 192, 128, True, 64, 150),
    (1, 2, 2, 7, 300, 64, 64, False, None, None),
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", ODD_CASES, ids=str)
def test_flash_plain_matches_attention_ref_where_the_tpu_refuses(case, dt):
    np_dt, _, _, tol = DTYPES[dt]
    B, Hq, Hkv, Sq, Skv, Dk, Dv, causal, window, offset = case
    assert not jk.attention_supported((B, Hq, Sq, Dk), (B, Hkv, Skv, Dk))
    assert kops.attention_supported((B, Hq, Sq, Dk), (B, Hkv, Skv, Dk),
                                    (B, Hkv, Skv, Dv), DTYPES[dt][2])
    q, k, v = _qkv(case, np_dt, seed=Sq + Skv + Dk)
    jout = j_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, window=window,
                           q_offset=None if offset is None else offset)
    out = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                  window=window, q_offset=offset)
    _close(to_numpy(out.float()), np.asarray(jnp.asarray(jout, jnp.float32)),
           tol)


def test_fully_masked_rows_are_exactly_zero():
    rng = np.random.default_rng(3)
    q, k, v = (_t(rng.normal(size=(1, 2, 16, 128)).astype(np.float32))
               for _ in range(3))
    # every row masked: the window cannot reach back to the keys
    out = ref.flash_attention_ref(q, k, v, causal=True, window=1,
                                  q_offset=4096)
    assert torch.equal(out, torch.zeros_like(out))
    jout = jk.flash_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                              jnp.asarray(v.numpy()), causal=True, window=1,
                              q_offset=jnp.int32(4096), interpret=True)
    np.testing.assert_allclose(np.asarray(jout), 0.0, atol=1e-6)
    # a negative offset hides every key from the first three rows only
    out = ref.flash_attention_ref(q, k, v, causal=True,
                                  q_offset=torch.tensor(-3))
    assert torch.equal(out[:, :, :3], torch.zeros_like(out[:, :, :3]))
    assert bool((out[:, :, 3:].abs().sum(-1) > 0).all())
    chunked = chunked_attention(q, k, v, causal=True, q_offset=-3, bk=8)
    assert torch.equal(chunked[:, :, :3], out[:, :, :3])


def test_flash_predicate_takes_what_the_kernel_can_read():
    bf, f32 = torch.bfloat16, torch.float32

    def ok(q, k, v, dt=bf):
        return kops.attention_supported(q, k, v, dt)

    # decode, prefill, paged-dense prefill, GQA, Dv != Dk, ragged lengths
    assert ok((4, 32, 1, 128), (4, 32, 256, 128), (4, 32, 256, 128))
    assert ok((4, 32, 128, 128), (4, 32, 128, 128), (4, 32, 128, 128))
    assert ok((1, 32, 100, 128), (1, 32, 100, 128), (1, 32, 100, 128))
    assert ok((4, 64, 1, 128), (4, 8, 256, 128), (4, 8, 256, 128))
    assert ok((1, 2, 128, 192), (1, 2, 128, 192), (1, 2, 128, 128), f32)
    assert ok((1, 2, 7, 64), (1, 2, 301, 64), (1, 2, 301, 256))
    assert ok((1, 2, 3, 8), (1, 2, 5, 8), (1, 2, 5, 8))
    # refused: rank, heads, 16-byte vectors, widths, dtype, mismatched
    # operands, 32-bit indexing
    assert not ok((32, 1, 128), (32, 256, 128), (32, 256, 128))
    assert not ok((1, 6, 4, 128), (1, 4, 4, 128), (1, 4, 4, 128))
    assert not ok((1, 2, 4, 100), (1, 2, 4, 100), (1, 2, 4, 100))
    assert not ok((1, 2, 4, 6), (1, 2, 4, 6), (1, 2, 4, 6), f32)
    assert not ok((1, 2, 4, 512), (1, 2, 4, 512), (1, 2, 4, 512))
    assert not ok((1, 2, 4, 128), (1, 2, 4, 128), (1, 2, 4, 264))
    assert not ok((1, 2, 4, 64), (1, 2, 4, 64), (1, 2, 4, 64),
                  torch.float64)
    assert not ok((1, 2, 4, 64), (2, 2, 4, 64), (2, 2, 4, 64))
    assert not ok((1, 2, 4, 64), (1, 2, 4, 64), (1, 2, 5, 64))
    assert not ok((1, 1, 1 << 24, 256), (1, 1, 8, 256), (1, 1, 8, 256))
    # the f32 route: 4 warps of 1, 2 or 4 rows, the most that the call's
    # rows fill and that leave a block an SM (decode: the query heads
    # of a kv head; phase 14's 32-token prompts of 1 and 4 slots; a
    # 128-token prefill of 4)
    p = kops.flash_plan((4, 32, 1, 128), (4, 32, 256, 128),
                        (4, 32, 256, 128), f32)
    assert (p.bq, p.warp_rows, p.grid, p.stages, p.packed) == \
        (4, 1, (1, 32, 4), 3, True)
    p = kops.flash_plan((1, 32, 32, 128), (1, 32, 32, 128),
                        (1, 32, 32, 128), f32)
    assert (p.bq, p.warp_rows, p.grid, p.stages) == (4, 1, (8, 32, 1), 1)
    p = kops.flash_plan((4, 32, 32, 128), (4, 32, 32, 128),
                        (4, 32, 32, 128), f32)
    assert (p.bq, p.warp_rows, p.grid) == (16, 4, (2, 32, 4))
    p = kops.flash_plan((4, 32, 128, 128), (4, 32, 128, 128),
                        (4, 32, 128, 128), f32)
    assert (p.bq, p.warp_rows, p.grid) == (16, 4, (8, 32, 4))
    # the f32 and 16-bit worst cases still fit one block's shared memory
    for dt in (f32, bf):
        assert kops.flash_plan((1, 2, 128, 256), (1, 2, 128, 256),
                               (1, 2, 128, 256), dt).smem <= 232448
    # a CPU refusal is no "rejected" CUDA call
    kernels.reset_counters()
    z = torch.zeros((1, 2, 4, 6))
    assert not kf.supported(z, z, z) and kf.rejected == 0


def _plan(q, k, v, dt=torch.bfloat16):
    return kops.flash_plan(q, k, v, dt)


def test_flash_plan_tensor_core_tiles():
    """The 16-bit launch: 16 query rows per warp, 64 rows a block in
    prefill (32 and two column halves past width 128), one 16-row
    fragment for Sq <= 16 with the 4 warps on column groups, and at
    decode the query heads of one kv head packed into the rows."""
    bf = torch.bfloat16
    # dense prefill 4x32x128: 2 row tiles x 32 heads x 4 slots
    p = _plan((4, 32, 128, 128), (4, 32, 128, 128), (4, 32, 128, 128))
    assert p.route == "tensor_core" and (p.bq, p.row_frags, p.col_groups,
                                         p.width) == (64, 4, 1, 128)
    assert p.grid == (2, 32, 4) and p.stages == 2 and not p.packed
    # decode at 256 keys: 3 of the 4 tiles in flight, two blocks an SM
    p = _plan((4, 32, 1, 128), (4, 32, 256, 128), (4, 32, 256, 128))
    assert (p.bq, p.row_frags, p.col_groups) == (16, 1, 4)
    assert p.grid == (1, 32, 4) and p.stages == 3 and p.packed
    assert 2 * (p.smem + 1024) <= 228 * 1024
    # GQA decode, Hq 64 over Hkv 8: 8 heads share a fragment and K/V
    p = _plan((4, 64, 1, 128), (4, 8, 256, 128), (4, 8, 256, 128))
    assert p.grid == (1, 8, 4) and p.bq == 16 and p.packed
    # more than 16 heads on one kv head: prefill-shaped row tiles
    p = _plan((1, 32, 1, 128), (1, 1, 300, 128), (1, 1, 300, 128))
    assert p.grid == (1, 1, 1) and p.bq == 64
    # a few query rows: one fragment, per head
    p = _plan((2, 4, 3, 64), (2, 4, 130, 64), (2, 4, 130, 64))
    assert (p.bq, p.width, p.grid, p.stages) == (16, 64, (1, 4, 2), 3)
    # the widest heads: 32 rows, 2 column halves, 3 stages
    p = _plan((1, 2, 100, 256), (1, 2, 300, 256), (1, 2, 300, 256))
    assert (p.bq, p.row_frags, p.col_groups, p.width, p.stages) == \
        (32, 2, 2, 256, 3)
    # MLA widths Dk 192, Dv 128 take the 256 class; Dk 40 pads to 48
    assert _plan((1, 2, 70, 192), (1, 2, 70, 192),
                 (1, 2, 70, 128)).width == 256
    p = _plan((1, 2, 17, 40), (1, 2, 64, 40), (1, 2, 64, 40), torch.float16)
    assert p.width == 64 and p.smem == (64 * 56 + 1 * 64 * (56 + 56)) * 2
    # f32 takes the CUDA cores in 4-group stages, GQA packed at decode:
    # Hq 64 over Hkv 8 in 2 blocks of 4 heads a kv head
    p = _plan((4, 64, 1, 128), (4, 8, 256, 128), (4, 8, 256, 128),
              torch.float32)
    assert p.route == "cuda_core" and p.packed and p.row_frags == 0
    assert (p.bq, p.grid, p.copy_groups) == (4, (2, 8, 4), 4)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16,
                                torch.float32])
@pytest.mark.parametrize("sq", [1, 3, 16, 17, 64, 100, 128])
@pytest.mark.parametrize("dk,dv", [(8, 8), (40, 40), (64, 64), (128, 128),
                                   (192, 128), (256, 256), (248, 136)])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 1), (32, 4)])
def test_flash_plan_covers_every_row_and_fits(hq, hkv, dk, dv, sq, dt):
    """Every query row lies in exactly one block, the ring holds 1-4
    stages, and the launch fits one block's shared memory, for every
    width the predicate takes (16-byte vectors up to 256); at decode (Sq
    1) the query heads of a kv head are packed into a block's rows."""
    for skv in (1, 64, 65, 256, 4096):
        q, k, v = (2, hq, sq, dk), (2, hkv, skv, dk), (2, hkv, skv, dv)
        assert kops.attention_supported(q, k, v, dt)
        p = kops.flash_plan(q, k, v, dt)
        rows = hq // hkv if sq == 1 else sq
        assert p.grid[0] * p.bq >= rows > (p.grid[0] - 1) * p.bq
        assert p.grid[1] == (hkv if sq == 1 else hq) and p.grid[2] == 2
        assert p.packed == (sq == 1)
        if dt == torch.float32:
            # 4 warps of 1, 2 or 4 rows, a block no larger than the call
            # needs but for 1-row warps; the mbarriers and Q, the ring's
            # alignment slack, then its K and V tiles in 128-byte boxes
            assert p.route == "cuda_core" and p.copy_groups == 4
            assert p.warp_rows in (1, 2, 4)
            assert p.bq == kops.FLASH_WARPS * p.warp_rows
            assert p.warp_rows == 1 or p.bq <= rows
            assert p.width == (128 if dv <= 128 else 256)
            assert 1 <= p.stages <= min(4, -(-skv // kops.FLASH_BK))
            boxes = kops.flash_f32_boxes(dk) + kops.flash_f32_boxes(dv)
            assert boxes * kops.FLASH_F32_BOX >= dk + dv
            stage = kops.FLASH_BK * boxes * kops.FLASH_F32_BOX * 4
            assert stage % kops.FLASH_F32_ALIGN == 0
            assert p.smem == (kops.FLASH_F32_BARS + p.bq * dk * 4
                              + kops.FLASH_F32_ALIGN + p.stages * stage
                              ) <= 232448
            continue
        assert p.row_frags * p.col_groups == kops.FLASH_WARPS
        assert p.bq == 16 * p.row_frags
        assert p.width >= max(dk, dv) and p.width % 64 == 0
        assert p.width // p.col_groups % 16 == 0
        assert 1 <= p.stages <= 4 and p.smem <= 232448
        # the whole ring in flight, never more stages than tiles
        ring = 3 if p.width == 256 or (p.width == 128 and
                                       p.row_frags == 1) else 4
        assert p.stages == min(ring, -(-skv // kops.FLASH_BK))


def test_p_split_keeps_f32_precision():
    """The p.V of the 16-bit flash kernel: p = hi + lo, hi = bf16(p), lo =
    bf16(p - hi), each half multiplied by v exactly and summed in f32.
    Emulated here on f32 tensors, it stays within 1e-4 of scale of the
    f32-p plain version (the Pallas kernel's function), where rounding p
    to bf16 alone (attention_ref's function) is an order of magnitude
    further off at the same inputs."""
    rng = np.random.default_rng(21)
    B, H, Sq, Skv, D = 1, 4, 64, 256, 128
    q = _t((3 * rng.normal(size=(B, H, Sq, D))).astype(np.float32)
           .astype(BF16))
    k, v = (_t(rng.normal(size=(B, H, Skv, D)).astype(np.float32)
               .astype(BF16)) for _ in range(2))
    qf, kf_, vf = q.float(), k.float(), v.float()
    expect = ref.flash_attention_ref(qf, kf_, vf, causal=True, q_offset=192)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf_) * D ** -0.5
    mask = ref.attention_mask(Sq, Skv, causal=True, window=None,
                              q_offset=192, device=CPU)
    s = torch.where(mask, s, torch.full((), ref.NEG_INF))
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)),
                    torch.zeros(()))
    l = p.sum(-1, keepdim=True)
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    split = (hi @ vf + lo @ vf) / l
    single = (hi @ vf) / l
    scale = max(float(expect.abs().max()), 1.0)
    err_split = float((split - expect).abs().max())
    err_single = float((single - expect).abs().max())
    print(f"p split: max err {err_split:.3e}, bf16(p) alone {err_single:.3e}, "
          f"scale {scale:.3e}")
    assert err_split <= 1e-4 * scale, err_split
    # bf16(p) alone: err_single is about 2e-3 of scale at these inputs
    assert err_single > 10 * err_split, (err_single, err_split)


@pytest.mark.parametrize("case", ATTN_CASES[:6], ids=str)
def test_chunked_attention_matches_jax(case):
    causal, window, offset = case[7:]
    q, k, v = _qkv(case, np.float32, seed=7)
    jout = j_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window,
                     q_offset=None if offset is None else jnp.int32(offset),
                     bk=128)
    out = chunked_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                            q_offset=None if offset is None
                            else torch.tensor(offset, dtype=torch.int32),
                            bk=128)
    _close(out.numpy(), np.asarray(jout), 1e-4)
    plain = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                    window=window, q_offset=offset)
    _close(out.numpy(), plain.numpy(), 1e-4)
    with pytest.raises(ValueError, match="not divisible"):
        chunked_attention(_t(q), _t(k), _t(v), bk=100)


def _attention_graph(ops, Function, sq, skv, d, offset):
    q = ops.parameter((1, 2, sq, d), "f32", "q")
    k = ops.parameter((1, 2, skv, d), "f32", "k")
    v = ops.parameter((1, 2, skv, d), "f32", "v")
    params = [q, k, v]
    off = None
    if offset:
        pos = ops.parameter((), "i32", "pos")
        params.append(pos)
        off = pos.out()
    out = ops.attention(q.out(), k.out(), v.out(), causal=True, q_offset=off)
    return Function(params, [out], "att")


@pytest.mark.parametrize("offset", [False, True])
def test_o1_attention_over_a_long_cache_runs_chunked(offset):
    """Sq > 1 over Skv > 2048 takes the chunked composition at O1 (it
    raised before the port had one) and gives the JAX emitter's
    output."""
    sq, skv, d = 4, 4096, 16
    rng = np.random.default_rng(11)
    args = [rng.normal(size=s).astype(np.float32)
            for s in ((1, 2, sq, d), (1, 2, skv, d), (1, 2, skv, d))]
    if offset:
        args.append(np.int32(skv - sq))
    tfn = _attention_graph(t_ops, TFunction, sq, skv, d, offset)
    jfn = _attention_graph(j_ops, JFunction, sq, skv, d, offset)
    tout = TBackend.create("torch", device="cpu").compile(
        tfn, TOptions(level="O1"))(*args)[0]
    jout = JBackend.create("jax").compile(jfn, JOptions(level="O1"))(*args)[0]
    _close(tout, jout, 1e-4)


# -- the CUDA kernel (skips without a card) ------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


# B, Hq, Hkv, Sq, Skv, Dk, Dv, causal, window, offset
CUDA_ATTN_CASES = [
    (4, 32, 32, 1, 256, 128, 128, True, None, 255),    # decode
    (4, 32, 32, 128, 128, 128, 128, True, None, None),  # prefill
    (2, 8, 2, 37, 300, 128, 128, True, None, 263),     # GQA, ragged
    (1, 4, 4, 100, 300, 64, 64, True, 48, 200),        # window, ragged
    (1, 2, 1, 70, 70, 192, 128, False, None, None),    # Dv != Dk, MQA
    (1, 2, 2, 3, 130, 256, 256, True, 16, 127),        # widest heads
]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", CUDA_ATTN_CASES, ids=str)
def test_cuda_flash_matches_plain(cuda_device, case, dt):
    _, _, t_dt, tol = DTYPES[dt]
    B, Hq, Hkv, Sq, Skv, Dk, Dv, causal, window, offset = case
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(sum(case[:7]))
    q, k, v = (torch.randn(s, generator=gen, device=cuda_device).to(t_dt)
               for s in ((B, Hq, Sq, Dk), (B, Hkv, Skv, Dk),
                         (B, Hkv, Skv, Dv)))
    # the offset is read from a tensor on the card
    off = None if offset is None else torch.tensor(
        offset, dtype=torch.int32, device=cuda_device)
    before = kf.launches
    out = kf.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=off)
    torch.cuda.synchronize()
    assert kf.launches == before + 1
    expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     q_offset=off)
    assert kf.launches == before + 1
    _close(to_numpy(out.float()), to_numpy(expect.float()), tol)


@pytest.mark.cuda
def test_cuda_flash_row_independent_of_query_tile(cuda_device):
    """A row's reduction order depends only on Skv and the mask: decode
    at position p gives row p of the causal prefill bit for bit, and a
    permuted (non-contiguous) view gives the same result."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(5)
    q, k, v = (torch.randn((2, 4, 200, 128), generator=gen,
                           device=cuda_device).to(torch.bfloat16)
               for _ in range(3))
    full = kf.flash_attention(q, k, v, causal=True)
    for p in (0, 63, 64, 130, 199):
        one = kf.flash_attention(q[:, :, p:p + 1], k, v, causal=True,
                                 q_offset=p)
        assert torch.equal(one, full[:, :, p:p + 1]), p
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not qt.is_contiguous() or qt.data_ptr() != q.data_ptr()
    assert torch.equal(kf.flash_attention(qt, k, v, causal=True), full)
    # fully-masked rows are exactly 0 on the card too
    dead = kf.flash_attention(q, k, v, causal=True, window=1, q_offset=4096)
    assert torch.equal(dead, torch.zeros_like(dead))


# the 16-bit tensor-core route: B, Hq, Hkv, Sq, Skv, Dk, Dv, causal,
# window, offset -- every head-width class, MLA widths, widths that are no
# multiple of 16 (zero-padded in shared memory), GQA rep 8 at decode
# (heads packed into one fragment) and in prefill, windows, and Sq of 1,
# 3, 16, 17, 64, 100 and 128
CUDA_TC_CASES = [
    (2, 4, 4, 1, 256, 64, 64, True, None, 255),
    (2, 4, 4, 3, 130, 128, 128, True, None, 127),
    (1, 2, 2, 16, 300, 256, 256, True, 40, 200),
    (1, 2, 1, 17, 70, 192, 128, False, None, None),
    (1, 2, 2, 64, 64, 40, 40, True, None, None),
    (2, 16, 2, 1, 256, 128, 128, True, None, 200),
    (1, 16, 2, 100, 100, 128, 128, True, None, None),
    (1, 4, 4, 128, 128, 128, 128, True, 32, None),
    (1, 2, 2, 128, 256, 72, 56, True, None, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bf16", "f16"])
@pytest.mark.parametrize("case", CUDA_TC_CASES, ids=str)
def test_cuda_flash_tensor_core_route(cuda_device, case, dt):
    _, _, t_dt, tol = DTYPES[dt]
    B, Hq, Hkv, Sq, Skv, Dk, Dv, causal, window, offset = case
    shapes = ((B, Hq, Sq, Dk), (B, Hkv, Skv, Dk), (B, Hkv, Skv, Dv))
    assert kops.flash_plan(*shapes, t_dt).route == "tensor_core"
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(sum(case[:7]))
    q, k, v = (torch.randn(s, generator=gen, device=cuda_device).to(t_dt)
               for s in shapes)
    off = None if offset is None else torch.tensor(
        offset, dtype=torch.int32, device=cuda_device)
    out = kf.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=off)
    torch.cuda.synchronize()
    expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     q_offset=off)
    _close(to_numpy(out.float()), to_numpy(expect.float()), tol)
    again = kf.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=off)
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bf16", "f16"])
@pytest.mark.parametrize("sq,off", [(1, 255), (1, 63), (128, None),
                                    (100, None)])
def test_cuda_flash_slot_alone_equals_slot_in_batch(cuda_device, sq, off,
                                                    dt):
    """A (slot, head) gives the same bits alone and inside a batch of 4,
    and fully masked rows are exactly 0 on the tensor-core route."""
    t_dt = DTYPES[dt][2]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(sq)
    skv = sq if off is None else 256
    q = torch.randn((4, 8, sq, 128), generator=gen,
                    device=cuda_device).to(t_dt)
    k, v = (torch.randn((4, 8, skv, 128), generator=gen,
                        device=cuda_device).to(t_dt) for _ in range(2))
    full = kf.flash_attention(q, k, v, causal=True, q_offset=off)
    alone = kf.flash_attention(q[2:3, 5:6], k[2:3, 5:6], v[2:3, 5:6],
                               causal=True, q_offset=off)
    assert torch.equal(full[2:3, 5:6].view(torch.int16),
                       alone.view(torch.int16))
    dead = kf.flash_attention(q, k, v, causal=True, window=1, q_offset=4096)
    assert torch.equal(dead, torch.zeros_like(dead))
    part = kf.flash_attention(q, k, v, causal=True,
                              q_offset=torch.tensor(-3, device=cuda_device))
    assert torch.equal(part[:, :, :3], torch.zeros_like(part[:, :, :3]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_cuda_d_head_64_graphs_match_jax(cuda_device, kind):
    """The emitter offers flash 64-wide heads too (minicpm-2b's d_head;
    the reference's TPU kernel takes multiples of 128 and composes
    these): a dense graph at d_head 64 runs its attention through the
    kernel on the card and matches JAX's composed attention (f32)."""
    from repro.configs import get_config as j_get_config
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.models import lm as j_lm
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import lm
    over = dict(d_model=256, n_heads=4, n_kv_heads=4, d_head=64,
                compute_dtype="f32")
    jcfg = j_get_config("minicpm-2b").reduced(**over)
    tcfg = get_config("minicpm-2b").reduced(**over)
    assert tcfg.head_dim == 64
    B, S = 2, 16
    jg = j_lm.build_graphs(jcfg, JShapeConfig(kind, kind, S, B), B)
    tg = lm.build_graphs(tcfg, ShapeConfig(kind, kind, S, B), B)
    assert jg.fn.signature() == tg.fn.signature()
    rng = np.random.default_rng(7)
    args = []
    for node in jg.builder.inputs:
        t = node.out_types[0]
        if node.name in ("tokens", "token"):
            args.append(rng.integers(0, jcfg.vocab, size=t.shape)
                        .astype(np.int32))
        elif node.name == "pos":
            args.append(np.int32(S // 2))
        else:   # caches
            args.append((rng.normal(size=t.shape) * 0.5).astype(t.dtype))
    params = jg.builder.init_params(0)
    args += [params[n] for n in jg.builder.param_names()]
    want = JBackend.create("jax").compile(jg.fn, JOptions(level="O1"))(*args)
    kernels.reset_counters()
    got = TBackend.create("torch", device="cuda", fresh=True).compile(
        tg.fn, TOptions(level="O2", use_pallas=True))(*args)
    assert kernels.counters()["flash_attention"]["launches"] > 0
    assert len(got) == len(want)
    for a, b in zip(want, got):
        _close(to_numpy(b), np.asarray(a), 1e-4)
