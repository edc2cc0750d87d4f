"""PyTorch port: every CUDA kernel against its plain PyTorch version on the
card, at edge shapes the serving and extraction paths can give (ragged row
counts, short and long keys, keys and queries that cut the attention
tiles, hd=96, 40, 32, 128 and 256, a fully padded key row, fp32 and fp16 inputs,
the int8 wrappers at fp32 activations, Lq != Lk, clips shorter than one
conv-stack tile or ending on a tile), and the WavLM core's gradient.

Needs an NVIDIA GPU: marked ``cuda`` and skipped without one. The file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import copy

import pytest
import torch

from hriemo_torch.frontends.wavlm import WavLMAttention, WavLMConfig, WavLMEncoder
from hriemo_torch.infer.streaming import MEASURED_BUCKET_BATCH
from hriemo_torch.nn.attention import MultiheadAttention
from hriemo_torch.nn.layers import MLP2, LayerNorm, Linear, init_torch_defaults
from hriemo_torch.ops import _cuda
from hriemo_torch.ops import attention_block as AB
from hriemo_torch.ops import conv_stack as CS
from hriemo_torch.ops import flash_attention as FA
from hriemo_torch.ops import fused_ffn as FF
from hriemo_torch.ops import wavlm_attention as WA
from hriemo_torch.ops import quant as Q
from hriemo_torch.ops.quant import quantize_for_serving

pytestmark = pytest.mark.cuda

# the kernel-path tolerance of the JAX kernel tests (tests/test_attention_block.py)
ATOL = RTOL = 5e-2
MEDIAN = 5e-3


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products and convs stay fp32
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator().manual_seed(0)


def _randn(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)


def _close(got, ref):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    diff = (got - ref).abs()
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)
    assert diff.median().item() < MEDIAN


def _pad_mask(lens, l):
    return (torch.arange(l)[None, :] >= torch.tensor(lens)[:, None]).cuda()


def _quantized(module, gen):
    init_torch_defaults(module, gen)
    return quantize_for_serving(module.to("cuda", torch.bfloat16).eval(), min_dim=128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("div127", [False, True])
def test_rowquant_bit_equal(gen, dtype, div127):
    """Both scale formulas, IEEE division and round-half-to-even: the int8
    rows and scales equal the plain versions bit for bit."""
    x = _randn(gen, 77, 768, dtype=dtype)
    x[3] = 0                      # the eps clamp
    x[5, :4] = torch.tensor([0.5, 1.5, -2.5, 127.0])  # halves and amax
    q, s = _cuda.rowquant(x, div127=div127)
    rq, rs = (Q.quantize_rowwise(x) if div127 else FF.quant_rows(x.float()))
    torch.testing.assert_close(q, rq, atol=0, rtol=0)
    torch.testing.assert_close(s, rs[:, 0], atol=0, rtol=0)


def test_quantize_on_card_equals_cpu(gen):
    """Serving quantizes on the card; its int8 weights and scales equal the
    CPU ones, which the CPU tests hold bit-equal to the JAX package."""
    w = torch.randn(768, 3072, generator=gen).to(torch.bfloat16)
    q, s = Q.quantize_linear_params(w.cuda())
    rq, rs = Q.quantize_linear_params(w)
    torch.testing.assert_close(q.cpu(), rq, atol=0, rtol=0)
    torch.testing.assert_close(s.cpu(), rs, atol=0, rtol=0)


# the int8 wrappers' activation dtypes: bf16 trees, and fp32 trees (int8
# weights at fp32 compute), where x, the residual and the output are fp32
ACT_DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("m,k,n,bias", [(1, 768, 768, True), (65, 512, 768, True),
                                        (130, 3072, 768, False), (4, 768, 2048, True)])
@pytest.mark.parametrize("dtype", ACT_DTYPES)
def test_int8_linear(gen, m, k, n, bias, dtype):
    """bf16 at the sublayer tolerance; fp32 bit-equal (the row quantize and
    the fp32 dequant epilogue round as the plain version does)."""
    lin = _quantized(Linear(k, n, bias), gen)
    x = _randn(gen, m, k, dtype=dtype)
    before = Q.int8_linear.launches
    got = Q.int8_linear(x, lin.w_int8, lin.w_scale, lin.bias_f32)
    assert Q.int8_linear.launches == before + 1
    ref = Q.int8_linear_plain(x, lin.w_int8, lin.w_scale, lin.bias_f32)
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    else:
        _close(got, ref)


# (d_in, F, d_out) of the FFN pair at each hidden width a model reaches:
# WavLM, BERT and the fusion FFNs at d=768; the fusion FFNs at d=256; the
# beta gate at d=256 (4d -> 256 -> d; at d=768 the TMA route does not take
# it, see test_ffn_pair_chain_route)
PAIR_WIDTHS = {3072: (768, 3072, 768), 1024: (256, 1024, 256), 256: (1024, 256, 256)}


def _routes(fn):
    return dict(fn.routes)


def _picked(fn, before, route):
    """The wrapper took ``route`` once since ``before`` and no other."""
    want = dict(before)
    want[route] = want.get(route, 0) + 1
    assert {k: v for k, v in fn.routes.items() if v} == {k: v for k, v in want.items() if v}


@pytest.mark.parametrize("fast_gelu", [True, False])
@pytest.mark.parametrize("m", [1, 63, 300, 2049])
@pytest.mark.parametrize("f", [256, 1024, 3072])
@pytest.mark.parametrize("dtype", ACT_DTYPES)
def test_ffn_block(gen, m, f, fast_gelu, dtype):
    """At every hidden width: the route ``_cuda.ffn_route`` picks, counted
    there, within the sublayer tolerance of plain, bit-equal to the chain
    where it is the chain; the TMA route (``route="tma"``, whose LayerNorm
    sums in another order) within the tolerance of plain where it takes the
    widths."""
    d = PAIR_WIDTHS[f][0] if f != 256 else 256
    pair = _quantized(MLP2(d, f, d), gen)
    ops = FF.FfnOperands(pair.ops, _randn(gen, d, dtype=torch.float32).abs(),
                         _randn(gen, d, scale=0.1, dtype=torch.float32))
    x = _randn(gen, m, d, dtype=dtype)
    epi = _cuda.EPI_GELU_F32 if fast_gelu else _cuda.EPI_GELU_ERF_F32
    before = _routes(FF.ffn_block_int8)
    got = FF.ffn_block_int8(x, ops, 1e-5, fast_gelu)
    _picked(FF.ffn_block_int8, before, _cuda.ffn_route(f, m, d, epi, _cuda.sm_count()))
    assert got.dtype == dtype
    _close(got, FF.ffn_block_int8_plain(x, ops, 1e-5, fast_gelu))
    before = _routes(FF.ffn_block_int8)
    chain = FF.ffn_block_int8(x, ops, 1e-5, fast_gelu, route="chain")
    _picked(FF.ffn_block_int8, before, "chain")
    if _cuda.ffn_route(f, m, d, epi, _cuda.sm_count()) != "tma":
        torch.testing.assert_close(got, chain, atol=0, rtol=0)
    if _cuda.ffn_tma_plan(f, d, d) is not None:
        before = _routes(FF.ffn_block_int8)
        tma = FF.ffn_block_int8(x, ops, 1e-5, fast_gelu, route="tma")
        _picked(FF.ffn_block_int8, before, "tma")
        _close(tma, FF.ffn_block_int8_plain(x, ops, 1e-5, fast_gelu))


@pytest.mark.parametrize("m", [1, 63, 300, 2049])
@pytest.mark.parametrize("f", [256, 1024, 3072])
@pytest.mark.parametrize("dtype", ACT_DTYPES)
def test_mlp2(gen, f, m, dtype):
    """As :func:`test_ffn_block`, for the ReLU pair without LayerNorm."""
    din, _, dout = PAIR_WIDTHS[f]
    ops = _quantized(MLP2(din, f, dout), gen).ops
    x = _randn(gen, m, din, dtype=dtype)
    before = _routes(FF.mlp2_int8)
    got = FF.mlp2_int8(x, ops)
    _picked(FF.mlp2_int8, before,
            _cuda.ffn_route(f, m, din, _cuda.EPI_RELU_F32, _cuda.sm_count()))
    assert got.dtype == dtype
    _close(got, FF.mlp2_int8_plain(x, ops))
    before = _routes(FF.mlp2_int8)
    chain = FF.mlp2_int8(x, ops, route="chain")
    _picked(FF.mlp2_int8, before, "chain")
    torch.testing.assert_close(got, chain, atol=0, rtol=0)
    if _cuda.ffn_tma_plan(f, din, dout, ln=False) is not None:
        before = _routes(FF.mlp2_int8)
        tma = FF.mlp2_int8(x, ops, route="tma")
        _picked(FF.mlp2_int8, before, "tma")
        torch.testing.assert_close(tma, chain, atol=0, rtol=0)


@pytest.mark.parametrize("kind,din,f", [("ffn", 128, 1408), ("mlp2", 128, 1408),
                                        ("mlp2", 3328, 256), ("mlp2", 3072, 256)])
def test_ffn_pair_chain_route(gen, kind, din, f):
    """A hidden width no power-of-two cluster spans (1408), or inputs too
    wide for the block's shared memory (K=3328, and the beta gate's K=3072
    at d=768), takes the named chain, counted there, at rows where the TMA
    route would be picked; a forced TMA route and an unknown route
    raise."""
    m = 9000
    pair = _quantized(MLP2(din, f, din), gen).ops
    x = _randn(gen, m, din)
    fn = FF.ffn_block_int8 if kind == "ffn" else FF.mlp2_int8
    if kind == "ffn":
        ops = FF.FfnOperands(pair, _randn(gen, din, dtype=torch.float32).abs(),
                             _randn(gen, din, scale=0.1, dtype=torch.float32))
        call = lambda route=None: fn(x, ops, 1e-5, True, route=route)  # noqa: E731
        ref = FF.ffn_block_int8_plain(x, ops, 1e-5, True)
    else:
        call = lambda route=None: fn(x, pair, route=route)  # noqa: E731
        ref = FF.mlp2_int8_plain(x, pair)
    before = _routes(fn)
    got = call()
    _picked(fn, before, "chain")
    _close(got, ref)
    assert _cuda.ffn_tma_plan(f, din, din, ln=kind == "ffn") is None
    with pytest.raises(ValueError, match="no block takes"):
        call("tma")
    with pytest.raises(ValueError, match="unknown route"):
        call("fused")


@pytest.mark.parametrize("bn,din,f", [(192, 768, 3072), (192, 768, 384), (128, 768, 2048),
                                      (128, 256, 1024), (128, 1280, 256)])
@pytest.mark.parametrize("m", [1, 65, 777])
@pytest.mark.parametrize("dtype", ACT_DTYPES)
def test_ffn_tma_gemm1_bit_equal(gen, bn, din, f, m, dtype):
    """The TMA route's first product at each block width, forced, over
    clusters of 2 to 16 blocks and up to the widest K a 128-column slice
    holds, each epilogue: int8 h and its row scales equal the row quantize
    of the shared GEMM's fp32 h bit for bit (x with a zero row, halves and a
    repeated maximum); a second call takes the weight's tensor map encoded
    by the first."""
    pair = _quantized(MLP2(din, f, 256), gen).ops
    x = _randn(gen, m, din, scale=3.0, dtype=dtype)
    x[0, :6] = torch.tensor([0.5, -1.5, 2.5, 0.0, 9.0, -9.0])
    if m > 1:
        x[1] = 0
    xq, xs = _cuda.ffn_tma_xquant(x)
    for epi in (_cuda.EPI_GELU_F32, _cuda.EPI_GELU_ERF_F32, _cuda.EPI_RELU_F32):
        rq, rs = _cuda.rowquant(_cuda.int8_gemm(xq, xs, pair.w1, pair.s1, pair.b1, epi),
                                div127=False)
        for _ in range(2):
            before = _cuda.ffn_tma_gemm1.launches
            hq, hs = _cuda.ffn_tma_gemm1(xq, xs, pair.w1, pair.s1, pair.b1, epi, bn=bn)
            assert _cuda.ffn_tma_gemm1.launches == before + 1
            torch.testing.assert_close(hq, rq, atol=0, rtol=0)
            torch.testing.assert_close(hs, rs, atol=0, rtol=0)
    assert sum(key[0] == id(pair.w1) for key in _cuda._WMAPS) == 1


@pytest.mark.parametrize("k", [256, 768, 1024, 3072])
@pytest.mark.parametrize("m", [1, 7, 9, 1001])
@pytest.mark.parametrize("dtype", ACT_DTYPES)
def test_ffn_tma_xquant_bit_equal(gen, k, m, dtype):
    """The TMA route's x quantize (one warp a row) gives ``hr_rowquant``'s
    codes and scales bit for bit (a zero row, halves, a repeated maximum)."""
    x = _randn(gen, m, k, scale=3.0, dtype=dtype)
    x[0, :6] = torch.tensor([0.5, -1.5, 2.5, 0.0, 9.0, -9.0])
    if m > 1:
        x[1] = 0
    q, s = _cuda.ffn_tma_xquant(x)
    rq, rs = _cuda.rowquant(x, div127=False)
    torch.testing.assert_close(q, rq, atol=0, rtol=0)
    torch.testing.assert_close(s, rs, atol=0, rtol=0)


# (kind, d_in, F, d_out): WavLM's FFN, the fusion FFN, the d=256 FFN and
# mlp2 (8 x 128 blocks, the LayerNorm over 2 x 128), the beta gate at d=256
TMA_WIDTHS = [("ffn", 768, 3072, 768), ("mlp2", 768, 3072, 768), ("ffn", 256, 1024, 256),
              ("mlp2", 1024, 256, 256)]


@pytest.mark.parametrize("kind,din,f,dout", TMA_WIDTHS)
@pytest.mark.parametrize("m", [1, 63, 129, 3072, 3992])
@pytest.mark.parametrize("dtype", ACT_DTYPES)
def test_ffn_tma_stores_every_tile(gen, kind, din, f, dout, m, dtype):
    """Ten launches of each TMA product in a row, each into outputs filled
    with what no correct output holds (-128 codes, NaN scales and outputs):
    every element is stored every time (an output from the caching
    allocator would hide an unstored tile behind an earlier launch's
    values); the codes and scales bit-equal to the chain's, mlp2's output
    bit-equal to the chain's and the FFN's within the tolerance of plain."""
    pair = _quantized(MLP2(din, f, dout), gen).ops
    x = _randn(gen, m, din, dtype=dtype)
    epi = _cuda.EPI_GELU_F32 if kind == "ffn" else _cuda.EPI_RELU_F32
    xq, xs = _cuda.ffn_tma_xquant(x)
    rq, rs = _cuda.rowquant(_cuda.int8_gemm(xq, xs, pair.w1, pair.s1, pair.b1, epi),
                            div127=False)
    norm = None
    if kind == "ffn":
        norm = (_randn(gen, dout, dtype=torch.float32).abs(),
                _randn(gen, dout, scale=0.1, dtype=torch.float32), 1e-5)
        ref = FF.ffn_block_int8_plain(x, FF.FfnOperands(pair, *norm[:2]), 1e-5, True)
    else:
        ref = FF.mlp2_int8(x, pair, route="chain")
    for _ in range(10):
        hq = torch.full((m, f), -128, dtype=torch.int8, device="cuda")
        hs = torch.full((m,), float("nan"), device="cuda")
        out = torch.full((m, dout), float("nan"), dtype=dtype, device="cuda")
        _cuda.ffn_tma_gemm1(xq, xs, pair.w1, pair.s1, pair.b1, epi, out=(hq, hs))
        _cuda.ffn_tma_gemm2(hq, hs, pair.w2, pair.s2, pair.b2, dtype,
                            resid=x if norm else None, norm=norm, out=out)
        torch.cuda.synchronize()
        torch.testing.assert_close(hq, rq, atol=0, rtol=0)
        torch.testing.assert_close(hs, rs, atol=0, rtol=0)
        assert not out.isnan().any()
        if kind == "ffn":
            _close(out, ref)
        else:
            torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_ffn_tma_layernorm_takes_128_columns(gen):
    """The second product with the LayerNorm has the 128-column block only:
    the route takes it, and a forced 192-column block raises, launching
    nothing; without the LayerNorm the 192-column block runs."""
    pair = _quantized(MLP2(768, 3072, 768), gen).ops
    x = _randn(gen, 300, 768)
    xq, xs = _cuda.ffn_tma_xquant(x)
    hq, hs = _cuda.ffn_tma_gemm1(xq, xs, pair.w1, pair.s1, pair.b1, _cuda.EPI_GELU_F32)
    norm = (_randn(gen, 768, dtype=torch.float32).abs(),
            _randn(gen, 768, scale=0.1, dtype=torch.float32), 1e-5)
    assert _cuda.ffn_tma_block2(768, 3072, True) == 128
    before = _cuda.ffn_tma_gemm2.launches
    with pytest.raises(RuntimeError):
        _cuda.ffn_tma_gemm2(hq, hs, pair.w2, pair.s2, pair.b2, x.dtype, resid=x, norm=norm,
                            bn=192)
    assert _cuda.ffn_tma_gemm2.launches == before
    wide = _cuda.ffn_tma_gemm2(hq, hs, pair.w2, pair.s2, pair.b2, x.dtype, bn=192)
    narrow = _cuda.ffn_tma_gemm2(hq, hs, pair.w2, pair.s2, pair.b2, x.dtype, bn=128)
    torch.testing.assert_close(wide, narrow, atol=0, rtol=0)


@pytest.mark.parametrize("l", [48, 62, 97, 124, 63, 65, 499, 1024])
@pytest.mark.parametrize("dtype", ACT_DTYPES)
def test_attention_block(gen, l, dtype):
    """fp32 x: the gate reads it as bf16 in the core's prologue, the
    residual and the LayerNorm stay fp32, and an fp32 position bias is
    rounded to bf16 as the TPU wrapper stores it."""
    d, h = 256, 4
    holder = torch.nn.Module()
    holder.attn, holder.ln = WavLMAttention(d, h, None), LayerNorm(d)
    holder = _quantized(holder, gen)
    with torch.no_grad():
        holder.attn.gru_rel_pos_const.fill_(1.3)
    ops = AB.wavlm_attn_operands(holder.attn, holder.ln)
    x = _randn(gen, 3, l, d, dtype=dtype)
    pos = _randn(gen, h, l, l, scale=0.3, dtype=dtype)
    kb = torch.where(_pad_mask([l, l - 17, l // 2], l), AB.NEG_INF, 0.0).float()
    got = AB.attention_block_int8(x, ops, pos, kb, 1e-5)
    assert got.dtype == dtype
    _close(got, AB.attention_block_int8_plain(x, ops, pos, kb, 1e-5))


@pytest.mark.parametrize("d,h,lq,lk,self_attn", [
    (256, 4, 8, 8, True), (256, 4, 33, 33, True), (384, 4, 50, 50, True),  # hd=96
    (256, 8, 16, 1024, False), (256, 8, 130, 9, False), (768, 8, 64, 499, False)])
@pytest.mark.parametrize("dtype", ACT_DTYPES)
def test_mha_block(gen, d, h, lq, lk, self_attn, dtype):
    ops = _quantized(MultiheadAttention(d, h), gen).ops
    xq = _randn(gen, 3, lq, d, dtype=dtype)
    xkv = xq if self_attn else _randn(gen, 3, lk, d, dtype=dtype)
    kpm = _pad_mask([lk, max(1, lk // 3), 0], lk)  # element 2: every key PAD
    got = AB.mha_block_int8(xq, xkv, ops, kpm)
    assert got.dtype == dtype
    _close(got, AB.mha_block_int8_plain(xq, xkv, ops, kpm))


EPILOGUES = [_cuda.EPI_BF16, _cuda.EPI_GELU_F32, _cuda.EPI_RELU_F32, _cuda.EPI_RESID_FIRST,
             _cuda.EPI_RESID_LAST, _cuda.EPI_GELU_ERF_F32, _cuda.EPI_F32]


def _gemm_operands(gen, m, n, k):
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8).cuda()
    w = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8).cuda()
    a_s = (torch.rand(m, generator=gen) * 1e-2 + 1e-4).cuda()
    w_s = (torch.rand(n, 1, generator=gen) * 1e-3 + 1e-5).cuda()
    return a, a_s, w, w_s


@pytest.mark.parametrize("m", [1, 4, 16, 63, 65, 129, 1996])
@pytest.mark.parametrize("epi", EPILOGUES)
@pytest.mark.parametrize("config", [-1, *range(len(_cuda.GEMM_CONFIGS))])
def test_int8_gemm_bit_equal(gen, m, epi, config):
    """The int32 sum is exact, so the GEMM equals its plain version bit for
    bit, for every epilogue and block configuration (-1: chosen by shape),
    at row counts that cut the 64- and 128-row tiles and N and K that cut
    the 64/128-column and 128-byte K tiles (K % 16 == 0); no bias at N=260,
    which also takes the unaligned-row stores. The residual epilogues read
    a bf16 residual (bf16 trees) and an fp32 one (fp32 trees)."""
    resid_epi = epi in (_cuda.EPI_RESID_FIRST, _cuda.EPI_RESID_LAST)
    for n, k in ((256, 784), (776, 512), (2304, 3072), (260, 512)):
        a, a_s, w, w_s = _gemm_operands(gen, m, n, k)
        bias = None if n == 260 else _randn(gen, n, dtype=torch.float32)
        for rdt in ACT_DTYPES if resid_epi else [None]:
            resid = None if rdt is None else _randn(gen, m, n, dtype=rdt)
            before = _cuda.int8_gemm.launches
            got = _cuda.int8_gemm(a, a_s, w, w_s, bias, epi, resid=resid, config=config)
            torch.cuda.synchronize()
            assert _cuda.int8_gemm.launches == before + 1
            torch.testing.assert_close(got, FF.int8_gemm_plain(a, a_s, w, w_s, bias, epi, resid),
                                       atol=0, rtol=0)


@pytest.mark.parametrize("m", [16, 65, 1996])
def test_int8_gemm_w_rows(gen, m):
    """Both slices of a packed [3D, D] in_proj (q rows, then k/v rows): W,
    its scales and bias offset by r0 rows without a copy."""
    d = 768
    a, a_s, w, w_s = _gemm_operands(gen, m, 3 * d, d)
    bias = _randn(gen, 3 * d, dtype=torch.float32)
    for r0, n in ((0, d), (d, 2 * d)):
        got = _cuda.int8_gemm(a, a_s, w, w_s, bias, _cuda.EPI_BF16, w_rows=(r0, n))
        ref = FF.int8_gemm_plain(a, a_s, w[r0:r0 + n], w_s[r0:r0 + n], bias[r0:r0 + n],
                                 _cuda.EPI_BF16)
        torch.testing.assert_close(got, ref, atol=0, rtol=0)


# (Lq, Lk) that cut the int8 core's tiles (64 query rows, 64 keys): the
# routing gates' ends 8 and 1024, one short of and one past a tile, 499 (the
# 10 s bucket), and Lq != Lk both ways (the fusion's cross-attention)
CORE_SHAPES = [(8, 8), (16, 16), (63, 63), (64, 64), (65, 65), (499, 499), (1024, 1024),
               (16, 499), (499, 16), (8, 1024), (1024, 8), (63, 65), (65, 63)]


@pytest.mark.parametrize("lq,lk", CORE_SHAPES)
# every head dim on the tile instances without the gate (40 zero-padded on
# 64, 192 and 256 on the wide tiles); gated, 64 and 96 on the tiles and the
# others on the CUDA-core kernel
@pytest.mark.parametrize("hd", [64, 96, 32, 40, 128, 192, 256])
@pytest.mark.parametrize("mode", ["gated", "kpm", "none", "gated_fp32_x"])
def test_attention_core_int8(gen, lq, lk, hd, mode):
    """q/k/v read in place as column blocks of packed projections; element
    2 has every key PAD (kbias -1e9 or kpm True) and still averages v.
    gated_fp32_x: the gate's x is an fp32 tree's activation, read as bf16."""
    b, h = 3, 4
    d = h * hd
    q = _randn(gen, b * lq, 2 * d, scale=hd ** -0.5)[:, d:]
    kv = _randn(gen, b * lk, 2 * d)
    k, v = kv[:, :d], kv[:, d:]
    pad = _pad_mask([lk, max(1, lk // 3), 0], lk)
    kw = {}
    if mode.startswith("gated"):
        xdt = torch.float32 if mode == "gated_fp32_x" else torch.bfloat16
        kw["kbias"] = torch.where(pad, AB.NEG_INF, 0.0).float()
        kw["gate"] = (_randn(gen, b * lq, d, dtype=xdt),
                      _randn(gen, 8, hd, scale=0.1, dtype=torch.float32),
                      _randn(gen, 8, scale=0.1, dtype=torch.float32),
                      _randn(gen, h, dtype=torch.float32), _randn(gen, h, lq, lk, scale=0.3))
    elif mode == "kpm":
        kw["kpm"] = pad
    before = AB.attention_core_int8.launches
    got = AB.attention_core_int8(q, k, v, b, h, **kw)
    torch.cuda.synchronize()
    assert AB.attention_core_int8.launches == before + 1
    ref = AB.attention_core_int8_plain(q, k, v, b, h, **kw)
    _close_attention(got.view(b, lq, d), ref.view(b, lq, d))


def test_wrappers_raise_instead_of_falling_back(gen):
    lin = _quantized(Linear(256, 256), gen)
    with pytest.raises(TypeError):      # fp16 activations: the kernel takes bf16 or fp32
        Q.int8_linear(_randn(gen, 4, 256, dtype=torch.float16), lin.w_int8, lin.w_scale)
    with pytest.raises(ValueError):     # a strided view is refused, not copied
        Q.int8_linear(_randn(gen, 256, 8).t(), lin.w_int8, lin.w_scale)


# the projections that quantize their own rows (csrc/proj_int8.cu), by
# (N, K) on the path: the WavLM sublayer's q/k/v (3 x 768 over 768), and
# int8_linear's widths in the served forward (the decoder's 768 -> 768, its
# FFN 768 -> 2048 -> 768, the feature projection 512 -> 768)
PROJ_WIDTHS = [(2304, 768), (768, 768), (768, 512), (2048, 768), (768, 2048)]


@pytest.mark.parametrize("n,k", PROJ_WIDTHS)
@pytest.mark.parametrize("m", [1, 65, 777])
@pytest.mark.parametrize("dtype", ACT_DTYPES)
def test_proj_gemm_bit_equal(gen, n, k, m, dtype):
    """Every form of the projection on the path, each block configuration
    that spans N (forced), equals the chain it replaces bit for bit: the row
    quantize (the kernels' scales for q/k/v, ``quantize_rowwise``'s for
    int8_linear) and the shared GEMM's epilogue; x with a zero row, halves
    and a repeated maximum; int8_linear also without a bias."""
    _, _, w, w_s = _gemm_operands(gen, 1, n, k)
    bias = _randn(gen, n, dtype=torch.float32)
    x = _randn(gen, m, k, scale=3.0, dtype=dtype)
    x[0, :6] = torch.tensor([0.5, -1.5, 2.5, 0.0, 9.0, -9.0])
    if m > 1:
        x[1] = 0
    forms = [(_cuda.out_epi(dtype), True, bias), (_cuda.out_epi(dtype), True, None)]
    if n == 3 * k:  # q/k/v: bf16 out over bf16 or fp32 x, the kernels' scales
        forms.append((_cuda.EPI_BF16, False, bias))
    for epi, div127, b_ in forms:
        out_bytes = 2 if epi == _cuda.EPI_BF16 else 4
        configs = [c for c in (0, 1) if _cuda.proj_cluster(n, k, out_bytes, config=c)]
        assert configs
        xq, xs = _cuda.rowquant(x, div127=div127)
        ref = _cuda.int8_gemm(xq, xs, w, w_s, b_, epi)
        for c in configs:
            before = _cuda.proj_gemm.launches
            got = _cuda.proj_gemm(x, w, w_s, b_, epi, div127, config=c)
            torch.cuda.synchronize()
            assert _cuda.proj_gemm.launches == before + 1
            torch.testing.assert_close(got, ref, atol=0, rtol=0)


@pytest.mark.parametrize("m", [1, 65, 777, 1996])
@pytest.mark.parametrize("config", [0, 1])
@pytest.mark.parametrize("dtype", ACT_DTYPES)
def test_proj_gemm_ln(gen, m, config, dtype):
    """The out-projection with the residual and the LayerNorm in its
    epilogue (768 columns over 2 x 384 or 3 x 256 blocks) against the chain
    (row quantize, the residual GEMM, the LayerNorm pass) at row 1's limit:
    y is the chain's bit for bit, only the LayerNorm's two sums are taken in
    another order."""
    d = 768
    _, _, w, w_s = _gemm_operands(gen, 1, d, d)
    bias = _randn(gen, d, dtype=torch.float32)
    ctx = _randn(gen, m, d, scale=0.2)
    x = _randn(gen, m, d, dtype=dtype)
    g, b = _randn(gen, d, dtype=torch.float32).abs(), _randn(gen, d, scale=0.1,
                                                              dtype=torch.float32)
    before = _cuda.proj_gemm_ln.launches
    got = _cuda.proj_gemm_ln(ctx, w, w_s, bias, x, g, b, 1e-5, config=config)
    torch.cuda.synchronize()
    assert _cuda.proj_gemm_ln.launches == before + 1 and got.dtype == dtype
    cq, cs = _cuda.rowquant(ctx, div127=False)
    y = _cuda.int8_gemm(cq, cs, w, w_s, bias, _cuda.EPI_RESID_LAST, resid=x)
    _close(got, _cuda.layernorm(y, g, b, 1e-5, dtype))
    _close(got, FF.layer_norm_rows(y, g, b, 1e-5).to(dtype))


# the gated core's score panel at key lengths that end and cut it: the
# 1.25 s bucket (62), one past (63), the 5 s and 10 s buckets, its longest row
@pytest.mark.parametrize("l", [62, 63, 128, 249, 499, 512])
@pytest.mark.parametrize("hd", [64, 96])
def test_attention_core_panel(gen, l, hd):
    """The panel kernel against the plain version and the two-sweep kernel
    on the same inputs, at ATTN_TOL, at every length it holds (the rule
    takes it gated for one key tile): element 1 padded, element 2 with every
    key masked (a finite average of v)."""
    b, h = 3, 4
    d = h * hd
    qkv = _randn(gen, b * l, 3 * d)
    qkv[:, :d] *= hd ** -0.5
    q, k, v = qkv.split(d, dim=1)
    kb = torch.where(_pad_mask([l, l - 17, 0], l), AB.NEG_INF, 0.0).float()
    gate = (_randn(gen, b * l, d), _randn(gen, 8, hd, scale=0.1, dtype=torch.float32),
            _randn(gen, 8, scale=0.1, dtype=torch.float32), _randn(gen, h, dtype=torch.float32),
            _randn(gen, h, l, l, scale=0.3))
    got = AB.attention_core_int8(q, k, v, b, h, kbias=kb, gate=gate, kernel="panel")
    _cuda.last_kernel("attention")
    AB.attention_core_int8(q, k, v, b, h, kbias=kb, gate=gate, kernel="panel")
    assert _cuda.last_kernel("attention") == ("onepass_panel_kernel", hd)
    two = AB.attention_core_int8(q, k, v, b, h, kbias=kb, gate=gate, kernel="sweeps")
    assert _cuda.last_kernel("attention") == ("onepass_mma_kernel", hd)
    ref = AB.attention_core_int8_plain(q, k, v, b, h, kbias=kb, gate=gate)
    assert torch.isfinite(got).all()
    _close_attention(got.view(b, l, d), ref.view(b, l, d))
    _close_attention(got.view(b, l, d), two.view(b, l, d))


@pytest.mark.parametrize("l", [62, 499, 1024])
@pytest.mark.parametrize("dtype", ACT_DTYPES)
def test_attention_block_routes(gen, l, dtype):
    """Both routes of the WavLM sublayer against the plain version, with
    their launches a call: three on the fused route (the q/k/v projection,
    the core, the out-projection with the LayerNorm), six on the chain; 1024
    keys take the two-sweep core on either."""
    d, h = 768, 12
    holder = torch.nn.Module()
    holder.attn, holder.ln = WavLMAttention(d, h, None), LayerNorm(d)
    holder = _quantized(holder, gen)
    ops = AB.wavlm_attn_operands(holder.attn, holder.ln)
    x = _randn(gen, 2, l, d, dtype=dtype)
    pos = _randn(gen, h, l, l, scale=0.3)
    kb = torch.where(_pad_mask([l, l // 2], l), AB.NEG_INF, 0.0).float()
    ref = AB.attention_block_int8_plain(x, ops, pos, kb, 1e-5)
    counters = (_cuda.rowquant, _cuda.int8_gemm, _cuda.layernorm, _cuda.proj_gemm,
                _cuda.proj_gemm_ln, AB.attention_core_int8)
    for route, launches in (("fused", 3), ("chain", 6)):
        before = sum(c.launches for c in counters), AB.attention_block_int8.routes[route]
        got = AB.attention_block_int8(x, ops, pos, kb, 1e-5, route=route)
        torch.cuda.synchronize()
        assert sum(c.launches for c in counters) - before[0] == launches
        assert AB.attention_block_int8.routes[route] == before[1] + 1
        assert got.dtype == dtype
        _close(got, ref)


def _ln_diff(got, ref):
    """The largest |got - ref| of two LayerNorm outputs and the share of
    elements whose bits differ. bf16: each within one bf16 ulp of the larger
    of the two magnitudes, a magnitude under 2^-8 counted as 2^-8 (the fp32
    sums in another order move a result by about 1e-6, more than an ulp of
    the tiniest values), and at most 1% of the elements differ (an add that
    rounds once where the caller rounds twice moves a third of them); fp32
    within 1e-5."""
    assert got.shape == ref.shape and got.dtype == ref.dtype and torch.isfinite(got).all()
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    if got.dtype == torch.float32:
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)
        return diff.max().item(), (diff > 0).float().mean().item()
    mag = torch.maximum(torch.maximum(g.abs(), r.abs()), torch.tensor(2.0 ** -8, device=g.device))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert (diff <= ulp).all(), f"{int((diff > ulp).sum())} elements beyond one ulp"
    share = (diff > 0).float().mean().item()
    assert share <= 0.01, f"{share:.4f} of the elements differ"
    return diff.max().item(), share


@pytest.mark.parametrize("m", [1, 65, 777, 23808])
@pytest.mark.parametrize("config", [0, 1])
@pytest.mark.parametrize("dtype", ACT_DTYPES)
def test_proj_gemm_ln_rounded(gen, m, config, dtype):
    """The MHA sublayer's out-projection with its caller's residual and
    LayerNorm (``rounded``): the projection stored in x's dtype, x added in
    x's dtype, the LayerNorm against the chain's store GEMM, the plain add
    and ``layer_norm_rows``; and the fp32 store form over bf16 ctx (an fp32
    tree's MHA output) bit-equal to the chain."""
    d = 768
    _, _, w, w_s = _gemm_operands(gen, 1, d, d)
    bias = _randn(gen, d, dtype=torch.float32)
    ctx = _randn(gen, m, d, scale=0.2)
    x = _randn(gen, m, d, dtype=dtype)
    g, b = _randn(gen, d, dtype=torch.float32).abs(), _randn(gen, d, scale=0.1,
                                                              dtype=torch.float32)
    before = _cuda.proj_gemm_ln.launches
    got = _cuda.proj_gemm_ln(ctx, w, w_s, bias, x, g, b, 1e-12, config=config, rounded=True)
    torch.cuda.synchronize()
    assert _cuda.proj_gemm_ln.launches == before + 1 and got.dtype == dtype
    cq, cs = _cuda.rowquant(ctx, div127=False)
    y = _cuda.int8_gemm(cq, cs, w, w_s, bias, _cuda.out_epi(dtype))
    print(f"M={m} config {config} {dtype}: max |d| and share differing "
          f"{_ln_diff(got, FF.layer_norm_rows((x + y).float(), g, b, 1e-12).to(dtype))}")
    if dtype == torch.float32 and _cuda.proj_cluster(d, d, 4, config=config):
        torch.testing.assert_close(
            _cuda.proj_gemm(ctx, w, w_s, bias, _cuda.EPI_F32, div127=False, config=config), y,
            atol=0, rtol=0)


# the MHA sublayer's call sites at d=768: BERT self (12 x 64) at 8 and 64
# tokens, the fusion stack's audio self, text self and both cross
# attentions (8 x 96) at the panel's and the two sweeps' key lengths
MHA_SITES = [(12, 8, 8, True), (12, 64, 64, True), (8, 62, 62, True), (8, 499, 499, True),
             (8, 62, 8, False), (8, 8, 62, False), (8, 499, 64, False), (8, 64, 499, False),
             (8, 130, 9, False)]


def _mha_fused_two_sweeps(xq, xkv, ops, kpm, norm):
    """The MHA sublayer's fused route from its public pieces with the core on
    the two sweeps, as the chain runs it: the projections that quantize
    their own rows, the core, the out-projection storing xq's dtype or with
    the residual and the LayerNorm."""
    b, lq, d = xq.shape
    x2 = xq.view(b * lq, d)
    if xkv is xq:
        q, k, v = _cuda.proj_gemm(x2, ops.w_in, ops.s_in, ops.b_in, _cuda.EPI_BF16,
                                  div127=False).split(d, dim=1)
    else:
        q = _cuda.proj_gemm(x2, ops.w_in[:d], ops.s_in[:d], ops.b_in[:d], _cuda.EPI_BF16,
                            div127=False)
        k, v = _cuda.proj_gemm(xkv.reshape(-1, d), ops.w_in[d:], ops.s_in[d:], ops.b_in[d:],
                               _cuda.EPI_BF16, div127=False).split(d, dim=1)
    ctx = AB.attention_core_int8(q, k, v, b, ops.n_heads, kpm=kpm, kernel="sweeps")
    if norm is None:
        out = _cuda.proj_gemm(ctx, ops.w_out, ops.s_out, ops.b_out, _cuda.out_epi(xq.dtype),
                              div127=False)
    else:
        out = _cuda.proj_gemm_ln(ctx, ops.w_out, ops.s_out, ops.b_out, x2, *norm, rounded=True)
    return out.view(b, lq, d)


@pytest.mark.parametrize("h,lq,lk,self_attn", MHA_SITES)
@pytest.mark.parametrize("dtype", ACT_DTYPES)
def test_mha_block_routes(gen, h, lq, lk, self_attn, dtype):
    """Both routes of the MHA sublayer with and without the caller's
    LayerNorm, launches a call (fused: 3 self, 4 cross; chain: 5 and 7 and
    the plain LayerNorm); the fused route's pieces with the core on the two
    sweeps: the store form bit-equal to the chain, the LayerNorm form within
    one bf16 ulp of the chain's plain one (its largest difference printed);
    each route as the wrapper runs it (the fused core on the panel up to its
    key length) within the sublayer tolerance of the plain version."""
    d, b = 768, 6
    ops = _quantized(MultiheadAttention(d, h), gen).ops
    xq = _randn(gen, b, lq, d, dtype=dtype)
    xkv = xq if self_attn else _randn(gen, b, lk, d, dtype=dtype)
    kpm = _pad_mask([lk, max(1, lk // 3), 0, lk, max(1, lk - 1), max(1, lk // 2)], lk)
    ln = (_randn(gen, d, dtype=torch.float32).abs() + 0.5,
          _randn(gen, d, scale=0.1, dtype=torch.float32), 1e-12 if h == 12 else 1e-5)
    counters = (_cuda.rowquant, _cuda.int8_gemm, _cuda.proj_gemm, _cuda.proj_gemm_ln,
                AB.attention_core_int8)
    want = {"fused": 3 if self_attn else 4, "chain": 5 if self_attn else 7}
    for norm in (None, ln):
        outs = {}
        for route in ("fused", "chain"):
            before = sum(c.launches for c in counters), AB.mha_block_int8.routes[route]
            outs[route] = AB.mha_block_int8(xq, xkv, ops, kpm, norm, route=route)
            torch.cuda.synchronize()
            assert sum(c.launches for c in counters) - before[0] == want[route]
            assert AB.mha_block_int8.routes[route] == before[1] + 1
            assert outs[route].dtype == dtype and outs[route].shape == (b, lq, d)
        two = _mha_fused_two_sweeps(xq, xkv, ops, kpm, norm)
        if norm is None:
            torch.testing.assert_close(two, outs["chain"], atol=0, rtol=0)
        else:
            print(f"{h}x{d // h} {lq}x{lk} {dtype}: the LayerNorm form against the chain, max "
                  f"|d| and share differing {_ln_diff(two, outs['chain'])}")
        ref = AB.mha_block_int8_plain(xq, xkv, ops, kpm, norm)
        for route in ("fused", "chain"):
            _close(outs[route], ref)


# the ungated core's score panel at the MHA sublayer's key lengths (8 and
# 64 tokens, 62 and 124 frames), one past a tile, past the panel's
# threshold and at its longest row; cross shapes both ways
@pytest.mark.parametrize("lq,lk", [(8, 8), (64, 64), (62, 62), (124, 124), (62, 8), (8, 62),
                                   (65, 65), (20, 129), (499, 499), (64, 512)])
@pytest.mark.parametrize("hd", [64, 96])
def test_attention_core_panel_ungated(gen, lq, lk, hd):
    """The ungated panel kernel (bool padding mask, additive bias, no mask)
    against the plain version and the two-sweep kernel on the same inputs at
    ATTN_TOL; element 2 with every key PAD still averages v."""
    b, h = 3, 4
    d = h * hd
    q = _randn(gen, b * lq, 2 * d, scale=hd ** -0.5)[:, d:]
    kv = _randn(gen, b * lk, 2 * d)
    k, v = kv[:, :d], kv[:, d:]
    pad = _pad_mask([lk, max(1, lk // 3), 0], lk)
    for kw in (dict(kpm=pad), dict(kbias=torch.where(pad, AB.NEG_INF, 0.0).float()), {}):
        got = AB.attention_core_int8(q, k, v, b, h, kernel="panel", **kw)
        _cuda.last_kernel("attention")
        AB.attention_core_int8(q, k, v, b, h, kernel="panel", **kw)
        assert _cuda.last_kernel("attention") == ("onepass_panel_kernel", hd)
        two = AB.attention_core_int8(q, k, v, b, h, kernel="sweeps", **kw)
        assert _cuda.last_kernel("attention") == ("onepass_mma_kernel", hd)
        ref = AB.attention_core_int8_plain(q, k, v, b, h, **kw)
        assert torch.isfinite(got).all()
        _close_attention(got.view(b, lq, d), ref.view(b, lq, d))
        _close_attention(got.view(b, lq, d), two.view(b, lq, d))
    # at the served batches the rule takes the panel to 320 keys but for four
    # key tiles
    assert (AB.core_kernel(lk, False, hd, 64) == "panel") == (
        lk <= AB.PANEL_MAX_KEYS or (lk <= AB.PANEL_MAX_KEYS_UNGATED and not 192 < lk <= 256))
    with pytest.raises(ValueError, match="no panel core"):  # no panel at head dim 32
        AB.attention_core_int8(_randn(gen, b * lq, 128), _randn(gen, b * lk, 128),
                               _randn(gen, b * lk, 128), b, 4, kernel="panel")


# the served WavLM lengths (the 14 buckets' frames), one past a key tile and
# the wgmma core's longest row
WGMMA_KEYS = [62, 65, 93, 124, 129, 156, 187, 218, 249, 281, 312, 343, 374, 406, 437, 499, 512]


@pytest.mark.parametrize("lk", WGMMA_KEYS)
@pytest.mark.parametrize("hd", [64, 96])
@pytest.mark.parametrize("mode", ["gated", "kpm"])
def test_attention_core_wgmma(gen, lk, hd, mode):
    """The wgmma core (``onepass_wgmma_kernel``) against the plain version
    at ATTN_TOL, gated (fp32 key bias) and ungated (bool padding mask), q/k/v
    read in place from packed projections, 65 query rows (a second row
    block of one row): element 1 padded, element 2 with every key masked
    (a finite average of v). The same core without its last key tile must
    fail ATTN_TOL."""
    b, h, lq = 3, 4, 65
    d = h * hd
    q = _randn(gen, b * lq, 3 * d, scale=hd ** -0.5)[:, d:2 * d]
    kv = _randn(gen, b * lk, 2 * d)
    k, v = kv[:, :d], kv[:, d:]
    pad = _pad_mask([lk, max(1, lk - 17), 0], lk)
    gate = None
    if mode == "gated":
        kw = dict(kbias=torch.where(pad, AB.NEG_INF, 0.0).float())
        gate = (_randn(gen, b * lq, d), _randn(gen, 8, hd, scale=0.1, dtype=torch.float32),
                _randn(gen, 8, scale=0.1, dtype=torch.float32), _randn(gen, h, dtype=torch.float32),
                _randn(gen, h, lq, lk, scale=0.3))
        kw["gate"] = gate
    else:
        kw = dict(kpm=pad)
    _cuda.last_kernel("attention")
    got = AB.attention_core_int8(q, k, v, b, h, kernel="wgmma", **kw)
    torch.cuda.synchronize()
    assert _cuda.last_kernel("attention") == ("onepass_wgmma_kernel", hd)
    assert torch.isfinite(got).all()
    ref = AB.attention_core_int8_plain(q, k, v, b, h, **kw)
    _close_attention(got.view(b, lq, d), ref.view(b, lq, d))
    n = (lk - 1) // 64 * 64  # without the last key tile
    cut = lambda t: t.reshape(b, lk, d)[:, :n].reshape(b * n, d)
    kwn = dict(kpm=pad[:, :n]) if gate is None else dict(
        kbias=kw["kbias"][:, :n], gate=(*gate[:4], gate[4][:, :, :n]))
    if n:
        wrong = AB.attention_core_int8_plain(q, cut(k), cut(v), b, h, **kwn)
        with pytest.raises(AssertionError):
            _close_attention(wrong.view(b, lq, d), ref.view(b, lq, d))


# the served cores by (gated, head dim, batch, key length): WavLM's at
# served batches either side of the panel's one key tile and past the old
# limits, the fusion stack's audio self-attention at its panel's edges, and
# the thin grids
ROUTE_CORES = [(True, 64, 384, 62), (True, 64, 192, 124), (True, 64, 128, 156),
               (True, 64, 64, 249), (True, 64, 32, 499), (True, 64, 1, 187), (True, 64, 4, 499),
               (False, 96, 384, 62), (False, 96, 128, 187), (False, 96, 64, 249),
               (False, 96, 64, 312), (False, 96, 64, 343), (False, 96, 32, 499),
               (False, 96, 4, 187), (False, 96, 1, 499)]


@pytest.mark.parametrize("gated,hd,b,lk", ROUTE_CORES)
def test_core_route_picks_the_fastest(gen, gated, hd, b, lk):
    """The kernel ``AB.core_kernel`` picks is the fastest of the three, or
    within CORE_ROUTE_MARGIN of it, each timed as chip_smoke.py times a row
    (a CUDA graph of calls, the median of 5 replays); every kernel within
    ATTN_TOL of the plain version."""
    from chip_smoke import cuda_ms

    d = 768
    h = d // hd
    qkv = _randn(gen, b * lk, 3 * d)
    qkv[:, :d] *= hd ** -0.5
    q, k, v = qkv.split(d, dim=1)
    pad = _pad_mask([lk] + [max(1, lk // 2)] * (b - 1), lk)
    if gated:
        kw = dict(kbias=torch.where(pad, AB.NEG_INF, 0.0).float(),
                  gate=(_randn(gen, b * lk, d), _randn(gen, 8, hd, scale=0.1, dtype=torch.float32),
                        _randn(gen, 8, scale=0.1, dtype=torch.float32),
                        _randn(gen, h, dtype=torch.float32), _randn(gen, h, lk, lk, scale=0.3)))
    else:
        kw = dict(kpm=pad)
    ref = AB.attention_core_int8_plain(q, k, v, b, h, **kw)
    ms = {}
    for kernel in AB.CORE_KERNELS:
        fn = lambda kernel=kernel: AB.attention_core_int8(q, k, v, b, h, kernel=kernel, **kw)
        _close_attention(fn().view(b, lk, d), ref.view(b, lk, d))
        ms[kernel] = cuda_ms(fn, repeats=5)
    picked = AB.core_kernel(lk, gated, hd, b)
    print(f"{'gated' if gated else 'ungated'} {h}x{hd} B={b} L={lk}: {ms}, picked {picked}")
    assert ms[picked] <= (1 + AB.CORE_ROUTE_MARGIN) * min(ms.values()), (picked, ms)


def test_wgmma_core_refused_launches_raise(gen):
    """What the wgmma core does not take raises, in the wrapper or from the
    C entry point, never falling back: more keys than it holds, a head dim
    other than 64 and 96, and the C entry point's own refusal."""
    b, h, hd = 2, 4, 64
    d = h * hd
    with pytest.raises(ValueError, match="no wgmma core"):
        AB.attention_core_int8(_randn(gen, b * 8, d), _randn(gen, b * 513, d),
                               _randn(gen, b * 513, d), b, h, kernel="wgmma")
    with pytest.raises(ValueError, match="no wgmma core"):
        AB.attention_core_int8(_randn(gen, b * 8, 128), _randn(gen, b * 8, 128),
                               _randn(gen, b * 8, 128), b, 4, kernel="wgmma")
    q, k, v = _randn(gen, b * 8, d), _randn(gen, b * 600, d), _randn(gen, b * 600, d)
    ctx = torch.empty_like(q)
    err = _cuda.lib("attention").hr_attention_core(
        q.data_ptr(), d, k.data_ptr(), d, v.data_ptr(), d, b, 8, 600, h, hd, None, None,
        None, 0, 0, None, None, None, None, ctx.data_ptr(), d, AB.CORE_KERNELS.index("wgmma"),
        _cuda.stream())
    with pytest.raises(RuntimeError):
        _cuda.check(err, "hr_attention_core")


def test_projection_routes_no_cluster_takes_the_chain(gen):
    """A width no cluster spans takes the named chain, counted there, at rows
    where the fused route would be picked; forcing the fused route raises.
    int8_linear at N=200 (no multiple of 256 or 384); the sublayer at d=128
    (its out-projection's 128 columns)."""
    lin = _quantized(Linear(256, 200), gen)
    x = _randn(gen, 30000, 256)
    assert _cuda.proj_cluster(200, 256) is None
    before = Q.int8_linear.routes["chain", 30000, 200, 256, 2]
    got = Q.int8_linear(x, lin.w_int8, lin.w_scale, lin.bias_f32)
    assert Q.int8_linear.routes["chain", 30000, 200, 256, 2] == before + 1
    _close(got, Q.int8_linear_plain(x, lin.w_int8, lin.w_scale, lin.bias_f32))
    with pytest.raises(ValueError, match="no cluster spans"):
        Q.int8_linear(x, lin.w_int8, lin.w_scale, lin.bias_f32, route="fused")
    with pytest.raises(ValueError, match="unknown route"):
        Q.int8_linear(x, lin.w_int8, lin.w_scale, lin.bias_f32, route="cluster")
    d, h, l = 128, 2, 250
    holder = torch.nn.Module()
    holder.attn, holder.ln = WavLMAttention(d, h, None), LayerNorm(d)
    holder = _quantized(holder, gen)
    ops = AB.wavlm_attn_operands(holder.attn, holder.ln)
    xa = _randn(gen, 128, l, d)
    pos = _randn(gen, h, l, l, scale=0.3)
    kb = torch.zeros(128, l, device="cuda")
    assert AB.attention_route(128 * l, d) == "chain"
    before = AB.attention_block_int8.routes["chain"]
    got = AB.attention_block_int8(xa, ops, pos, kb, 1e-5)
    assert AB.attention_block_int8.routes["chain"] == before + 1
    _close(got, AB.attention_block_int8_plain(xa, ops, pos, kb, 1e-5))
    with pytest.raises(ValueError, match="no cluster spans"):
        AB.attention_block_int8(xa, ops, pos, kb, 1e-5, route="fused")


@pytest.mark.parametrize("m", [1, 4096])
@pytest.mark.parametrize("dtype", ACT_DTYPES)
def test_int8_linear_routes(gen, m, dtype):
    """int8_linear's two routes give the same bits, one launch on the fused
    route and two on the chain, each counted by (route, M, N, K)."""
    lin = _quantized(Linear(512, 768), gen)
    x = _randn(gen, m, 512, dtype=dtype)
    counters = (_cuda.rowquant, _cuda.int8_gemm, _cuda.proj_gemm)
    outs = {}
    for route, launches in (("fused", 1), ("chain", 2)):
        key = (route, m, 768, 512, x.element_size())
        before = sum(c.launches for c in counters), Q.int8_linear.routes[key]
        outs[route] = Q.int8_linear(x, lin.w_int8, lin.w_scale, lin.bias_f32, route=route)
        torch.cuda.synchronize()
        assert sum(c.launches for c in counters) - before[0] == launches
        assert Q.int8_linear.routes[key] == before[1] + 1
    torch.testing.assert_close(outs["fused"], outs["chain"], atol=0, rtol=0)


def _heads_view(gen, b, l, h, hd, dtype):
    """[B, H, L, hd] head view of a [B, L, H*hd] projection, as the routes pass it."""
    return _randn(gen, b, l, h * hd, dtype=dtype).view(b, l, h, hd).transpose(1, 2)


# chip_smoke.py's ATTN_TOL: (atol, rtol, median per batch element)
ATTN_TOL = {torch.float32: (1e-4, 1e-4, 1e-5), torch.bfloat16: (8e-3, 1e-2, 1e-3),
            torch.float16: (1e-3, 1e-3, 1.25e-4)}


def _close_attention(got, ref):
    """An attention core's raw output (|values| of a few hundredths to a few
    tenths) against its plain version, at chip_smoke.py's ATTN_TOL: fp32
    sums in another order only, or one bf16 (fp16) rounding of the same p
    and output; the median is taken per batch element, so an error confined
    to one element's rows still fails."""
    atol, rtol, median = ATTN_TOL[got.dtype]
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
        return
    got, ref = got.float(), ref.float()
    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
    assert (got - ref).abs().flatten(1).median(dim=1).values.max().item() < median


# (Lq, Lk) that cut the tensor-core kernels' tiles (64 query rows; 64 keys
# one-pass, 128 streaming): one row or key, one short of and one past a
# tile, 1499 and 2249 (the 30 s and 45 s clips), Lq != Lk both ways. Odd and
# other non-multiples of 8 leave the gated pos rows off 16-byte alignment.
ATTN_SHAPES = [(128, 128), (130, 130), (2048, 2048), (1, 1), (63, 63), (65, 65),
               (1499, 1499), (2249, 2249), (1, 65), (63, 1499), (1499, 63), (2249, 130)]
# Without a gate, bf16, fp16 and fp32 run 32, 64, 96, 128, 192 and 256 on
# their tensor-core instances, 40 zero-padded on the 64 one and 136 on the
# 192 one; the gated core runs 64 and 96 on the tensor cores and the others
# on CUDA cores
ATTN_HEAD_DIMS = [64, 96, 40, 32, 128, 256, 136, 192]
ATTN_DTYPES = [torch.bfloat16, torch.float32, torch.float16]


@pytest.mark.parametrize("lq,lk", ATTN_SHAPES)
@pytest.mark.parametrize("hd", ATTN_HEAD_DIMS)
@pytest.mark.parametrize("dtype", ATTN_DTYPES)
def test_wavlm_fused_attention(gen, lq, lk, hd, dtype):
    """Element 1 has every key masked (a pad_flush filler clip)."""
    b, h = 3, 4
    q = _heads_view(gen, b, lq, h, hd, dtype)
    k, v = (_heads_view(gen, b, lk, h, hd, dtype) for _ in range(2))
    gate = (torch.rand(b, h, lq, generator=gen) * 1.5 + 0.5).to("cuda", dtype)
    pos = _randn(gen, h, lq, lk, scale=0.3, dtype=dtype)
    kb = torch.where(_pad_mask([lk, 0, lk // 3], lk), AB.NEG_INF, 0.0).float()
    before = WA.wavlm_fused_attention.launches
    got = WA.wavlm_fused_attention(q, k, v, gate, pos, kb)
    torch.cuda.synchronize()
    assert WA.wavlm_fused_attention.launches == before + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    _close_attention(got, WA.wavlm_fused_attention_plain(q, k, v, gate, pos, kb))


@pytest.mark.parametrize("lq,lk", [(1024, 1024), (130, 2048), (1030, 128), (1024, 2049),
                                   (2049, 130), (33, 2249), (1, 1), (63, 65), (65, 63),
                                   (1499, 1499), (2249, 2249), (1, 2249), (2249, 1)])
@pytest.mark.parametrize("hd", ATTN_HEAD_DIMS)
@pytest.mark.parametrize("dtype", ATTN_DTYPES)
def test_flash_kernels(gen, lq, lk, hd, dtype):
    """Both kernels at every shape (the one-pass one up to 2048 keys), with
    one element whose keys are all masked; flash_mha's dispatch."""
    b, h = 3, 8
    q = _heads_view(gen, b, lq, h, hd, dtype)
    k, v = (_heads_view(gen, b, lk, h, hd, dtype) for _ in range(2))
    kpm = _pad_mask([lk, lk // 3, 0], lk)
    bias = FA.key_bias(kpm, b, lk, q.device)
    kernels = [(FA.streaming_attention, FA.streaming_attention_plain)]
    if lk <= FA.ONEPASS_MAX_LK:
        kernels.append((FA.onepass_attention, FA.onepass_attention_plain))
    for fn, plain in kernels:
        before = fn.launches
        got = fn(q, k, v, bias)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.dtype == dtype and torch.isfinite(got).all()
        _close_attention(got, plain(q, k, v, bias))
    routed = FA.onepass_attention if lk <= FA.ONEPASS_MAX_LK else FA.streaming_attention
    before = routed.launches
    FA.flash_mha(q, k, v, kpm)
    assert routed.launches == before + 1


def test_attention_kernels_raise_instead_of_falling_back(gen):
    q = _heads_view(gen, 1, 64, 2, 64, torch.bfloat16)
    kb = torch.zeros(1, 64, device="cuda")
    with pytest.raises(TypeError):      # float64 is not a dtype of the kernels
        FA.onepass_attention(q.double(), q.double(), q.double(), kb)
    with pytest.raises(ValueError):     # rows must be contiguous
        FA.streaming_attention(q.transpose(-1, -2), q, q, kb)
    with pytest.raises(TypeError):      # the position bias has q's dtype
        WA.wavlm_fused_attention(q, q, q, torch.ones(1, 2, 64, device="cuda"),
                                 torch.zeros(2, 64, 64, device="cuda"), kb)
    # the tensor-core kernels (without a gate every head dim up to 256 in
    # bf16, fp16 and fp32) keep no score panel, so 8192 keys run; gated at
    # hd 40, the CUDA-core kernel's panel [16, 8192] must fit shared memory
    # and does not
    kb_long = torch.zeros(1, 8192, device="cuda")
    for dt in (torch.bfloat16, torch.float32, torch.float16):
        for hd in (64, 40, 128, 256):
            long = _heads_view(gen, 1, 8192, 2, hd, dt)
            q_hd = _heads_view(gen, 1, 64, 2, hd, dt)
            assert torch.isfinite(FA.onepass_attention(q_hd, long, long, kb_long)).all()
    q40 = _heads_view(gen, 1, 64, 2, 40, torch.float32)
    with pytest.raises(ValueError):
        long = _heads_view(gen, 1, 8192, 2, 40, torch.float32)
        WA.wavlm_fused_attention(q40, long, long, torch.ones(1, 2, 64, device="cuda"),
                                 torch.zeros(2, 64, 8192, device="cuda"), kb_long)


def test_attention_instances(gen):
    """The one dispatch of the flash cores in each dtype (fp32 included):
    each head dim up to 256 on the smallest tile instance at or above it;
    the gated core on its instances 64 and 96 only (0: the CUDA-core
    kernel)."""
    onepass = _cuda.lib("wavlm_attention").hr_onepass_instance
    streaming = _cuda.lib("flash_attention").hr_streaming_instance
    for code in (_cuda.DTYPE_CODES[dt] for dt in ATTN_DTYPES):
        for hd in range(8, 257, 8):
            want = next(t for t in (32, 64, 96, 128, 192, 256) if t >= hd)
            assert streaming(hd, code) == onepass(hd, 0, code) == want
            assert onepass(hd, 1, code) == (hd if hd in (64, 96) else 0)
    assert streaming(64, 7) == onepass(64, 0, 7) == 0  # no kernel takes dtype code 7


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
def test_attention_launch_record(gen, dtype):
    """Each library records the attention kernel it launched last and its
    head dim (``_cuda.last_kernel``): the tile kernel of the dispatched
    instance, narrow or wide, and with ``cuda_cores`` the CUDA-core kernel
    at hd; reading the record clears it. The streaming core is pinned to
    ``csrc/flash_attention.cu`` (``kernel="mma"``), which bf16 and fp16 leave
    for the wgmma library where the rule picks it (that library's record:
    ``test_streaming_wgmma_kernels``)."""
    b, h, l = 2, 2, 80
    wide, narrow = ("attn_tf32_wide_kernel", "attn_tf32_kernel") if dtype == torch.float32 \
        else ("streaming_wide_kernel", "streaming_mma_kernel")
    for hd, inst in ((40, 64), (128, 128), (136, 192), (256, 256)):
        q, k, v = (_heads_view(gen, b, l, h, hd, dtype) for _ in range(3))
        kb = torch.zeros(b, l, device="cuda")
        _cuda.last_kernel("flash_attention")
        FA.streaming_attention(q, k, v, kb, "mma")
        assert _cuda.last_kernel("flash_attention") == (wide if inst > 128 else narrow, inst)
        assert _cuda.last_kernel("flash_attention") == (None, 0)
        FA.streaming_launch(q, k, v, kb, cuda_cores=True)
        assert _cuda.last_kernel("flash_attention") == ("streaming_attn_kernel", hd)
    torch.cuda.synchronize()


@pytest.mark.parametrize("hd, kernel", [
    (hd, kernel) for hd in (64, 96, 192, 256) for kernel in ("gated", "onepass", "streaming")
    if hd <= 128 or kernel != "gated"])  # no gated instance on the wide tiles
def test_fp32_attention_at_large_scores(gen, kernel, hd):
    """q and k scaled so that the scores reach about +-30: the fp32
    kernels' 3xTF32 products hold ATTN_TOL[fp32], on the narrow tiles and
    the wide ones, where the same plain version with its two products in
    TF32 (one TF32 product each, as cuBLAS runs them with TF32 allowed)
    does not."""
    b, h = 2, 4
    lq = lk = 2249 if kernel == "streaming" else 499
    q, k = (_heads_view(gen, b, lq, h, hd, torch.float32) * 2.5 for _ in range(2))
    v = _heads_view(gen, b, lk, h, hd, torch.float32)
    kb = torch.where(_pad_mask([lk, lk // 3], lk), AB.NEG_INF, 0.0).float()
    if kernel == "gated":
        gate = (torch.rand(b, h, lq, generator=gen) * 1.5 + 0.5).cuda()
        pos = _randn(gen, h, lq, lk, scale=0.3, dtype=torch.float32)
        fn = lambda: WA.wavlm_fused_attention(q, k, v, gate, pos, kb)
        plain = lambda: WA.wavlm_fused_attention_plain(q, k, v, gate, pos, kb)
    else:
        name = f"{kernel}_attention"
        fn = lambda: getattr(FA, name)(q, k, v, kb)
        plain = lambda: getattr(FA, name + "_plain")(q, k, v, kb)
    s = WA.scaled_scores(q, k)
    assert s.abs().max().item() > 25
    ref = plain()
    _close_attention(fn(), ref)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one_tf32 = plain()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    with pytest.raises(AssertionError):
        _close_attention(one_tf32, ref)


# ------------------------------------------- the one-pass cores on wgmma (PR 24)
# Key lengths at the held form's tile and route edges (64-key tiles, 512
# keys) and the two sweeps' (64-key tiles at hd 64 and 96, 32 on the wide
# tiles) up to the one-pass limit; odd lengths leave the gated pos rows off
# 16-byte alignment
ONEPASS_KEYS = [128, 129, 192, 193, 256, 257, 511, 512, 513, 1024, 2047, 2048]
ONEPASS_HEADS = [(64, True), (96, True), (64, False), (96, False), (136, False), (192, False),
                 (200, False), (256, False)]
WGMMA_CASES = [(kernel, lk, hd, gated) for lk in ONEPASS_KEYS for hd, gated in ONEPASS_HEADS
               for kernel in WA.onepass_kernels(lk, hd, gated, torch.bfloat16)[1:]]


def _onepass_case(gen, b, h, lq, lk, hd, dtype, gated):
    """(the wrapper called with a kernel, its plain version, the wrapper) on
    head views, element 1 (where b > 1) with every key masked."""
    q = _heads_view(gen, b, lq, h, hd, dtype)
    k, v = (_heads_view(gen, b, lk, h, hd, dtype) for _ in range(2))
    lens = ([lk, 0] + [lk // 3] * b)[:b]
    kb = torch.where(_pad_mask(lens, lk), AB.NEG_INF, 0.0).float()
    if not gated:
        return (lambda kernel=None: FA.onepass_attention(q, k, v, kb, kernel),
                lambda: FA.onepass_attention_plain(q, k, v, kb), FA.onepass_attention)
    gate = (torch.rand(b, h, lq, generator=gen) * 1.5 + 0.5).to("cuda", dtype)
    pos = _randn(gen, h, lq, lk, scale=0.3, dtype=dtype)
    return (lambda kernel=None: WA.wavlm_fused_attention(q, k, v, gate, pos, kb, kernel),
            lambda: WA.wavlm_fused_attention_plain(q, k, v, gate, pos, kb),
            WA.wavlm_fused_attention)


def _run_counted(fn, wrapper, kernel, hd, forced):
    """One call, counted once on the wrapper and once under its kernel, and
    launched as that kernel at its tile instance (the library's record)."""
    before, by_kernel = wrapper.launches, wrapper.kernels[kernel]
    _cuda.last_kernel("attention_wgmma")
    got = fn(kernel if forced else None)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and wrapper.kernels[kernel] == by_kernel + 1
    inst = hd if hd <= 96 else 192 if hd <= 192 else 256
    name = "onepass_wgmma_kernel" if kernel == "wgmma" else "onepass_sweeps_kernel"
    assert _cuda.last_kernel("attention_wgmma") == (name, inst)
    return got


@pytest.mark.parametrize("kernel,lk,hd,gated", WGMMA_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_onepass_wgmma_kernels(gen, kernel, lk, hd, gated, dtype):
    """Each wgmma kernel, pinned through the wrapper's ``kernel``, at every
    key length it takes at the tile and route edges, in bf16 and fp16, Lq
    not a multiple of 64 or 128, one element with every key masked: within
    ATTN_TOL of the plain version, counted once on its wrapper."""
    lq = lk + 37 if lk < 2000 else lk - 61
    fn, plain, wrapper = _onepass_case(gen, 3, 2, lq, lk, hd, dtype, gated)
    got = _run_counted(fn, wrapper, kernel, hd, forced=True)
    assert got.dtype == dtype and torch.isfinite(got).all()
    _close_attention(got, plain())


# the rows 6-7 grids the paths run (phase 3's shapes) and thin grids: (B, H,
# L, hd, gated)
ONEPASS_GRIDS = [(64, 12, 249, 64, True), (32, 12, 499, 64, True), (8, 12, 499, 64, True),
                 (2, 12, 1499, 64, True), (2, 8, 1499, 96, False), (16, 4, 1951, 64, False),
                 (2, 4, 1499, 192, False), (16, 1, 1951, 256, False), (1, 1, 499, 64, True),
                 (1, 1, 1499, 64, True), (1, 1, 1024, 96, False), (1, 1, 1951, 256, False)]


@pytest.mark.parametrize("b,h,l,hd,gated", ONEPASS_GRIDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_onepass_wgmma_grids(gen, b, h, l, hd, gated, dtype):
    """The kernel ``WA.onepass_route`` picks at the paths' grids and thin
    ones runs, counted under its name, within ATTN_TOL of plain."""
    fn, plain, wrapper = _onepass_case(gen, b, h, l, l, hd, dtype, gated)
    # head views: strides TMA describes
    kernel = WA.onepass_kernel(l, hd, gated, dtype, b=b, h=h, sms=_cuda.sm_count())
    if kernel == "mma":
        before = wrapper.kernels["mma"]
        got = fn()
        assert wrapper.kernels["mma"] == before + 1
    else:
        got = _run_counted(fn, wrapper, kernel, hd, forced=False)
    _close_attention(got, plain())


# rows 6-7 at the paths' shapes: (B, H, L, hd, gated, dtype)
ROUTE_ONEPASS = [(64, 12, 249, 64, True, torch.bfloat16), (32, 12, 499, 64, True, torch.bfloat16),
                 (8, 12, 499, 64, True, torch.bfloat16), (2, 12, 1499, 64, True, torch.bfloat16),
                 (2, 12, 1499, 64, True, torch.float16), (2, 8, 1499, 96, False, torch.bfloat16),
                 (16, 4, 1951, 64, False, torch.bfloat16), (16, 4, 1951, 64, False, torch.float16),
                 (2, 4, 1499, 192, False, torch.bfloat16), (16, 1, 1951, 256, False, torch.bfloat16),
                 (16, 8, 1951, 32, False, torch.bfloat16), (16, 2, 1951, 128, False, torch.bfloat16)]


@pytest.mark.parametrize("b,h,l,hd,gated,dtype", ROUTE_ONEPASS)
def test_onepass_route_picks_the_fastest(gen, b, h, l, hd, gated, dtype):
    """The kernel ``WA.onepass_kernel`` picks is the fastest of those that
    take the shape, or within ONEPASS_ROUTE_MARGIN of it (each timed as
    chip_smoke.py times a row)."""
    from chip_smoke import cuda_ms

    fn, plain, _ = _onepass_case(gen, b, h, l, l, hd, dtype, gated)
    ms = {kn: cuda_ms(lambda kn=kn: fn(kn), repeats=5)
          for kn in WA.onepass_kernels(l, hd, gated, dtype)}
    picked = WA.onepass_kernel(l, hd, gated, dtype, b=b, h=h, sms=_cuda.sm_count())
    print(f"{'gated' if gated else 'ungated'} {h}x{hd} B={b} L={l} {dtype}: {ms}, picked {picked}")
    assert ms[picked] <= (1 + WA.ONEPASS_ROUTE_MARGIN) * min(ms.values()), (picked, ms)


def test_onepass_wgmma_refused_launches_raise(gen):
    """What a wgmma kernel does not take raises from its C entry point,
    never falling back: the held form past 512 keys, the two sweeps past
    2048 keys, at hd 40 and gated on the wide tiles, fp32; and the CUDA-core
    yardstick names no wgmma kernel."""
    def case(lk, hd, dtype, gated):
        return _onepass_case(gen, 2, 2, 64, lk, hd, dtype, gated)[0]
    for fn, kernel in ((case(513, 64, torch.bfloat16, True), "wgmma"),
                       (case(2049, 64, torch.bfloat16, False), "wgmma_sweeps"),
                       (case(256, 40, torch.bfloat16, False), "wgmma_sweeps"),
                       (case(256, 192, torch.bfloat16, True), "wgmma_sweeps"),
                       (case(256, 64, torch.float32, True), "wgmma"),
                       (case(256, 64, torch.float32, False), "wgmma_sweeps")):
        with pytest.raises(RuntimeError, match="hr_onepass_wgmma"):
            fn(kernel)
    q = _heads_view(gen, 1, 64, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        WA.onepass_launch(q, q, q, torch.zeros(1, 64, device="cuda"), cuda_cores=True,
                          kernel="wgmma")


def test_onepass_wgmma_instances(gen):
    """The C entry point's instances: the held form at hd 64 and 96, the
    two sweeps there and, ungated, at the wide tiles 192 (hd 136-192) and
    256 (200-256), bf16 and fp16 only; and its key limits."""
    inst = _cuda.lib("attention_wgmma").hr_onepass_wgmma_instance
    for code in (_cuda.DTYPE_CODES[torch.bfloat16], _cuda.DTYPE_CODES[torch.float16]):
        for hd in range(8, 257, 8):
            narrow = hd if hd in (64, 96) else 0
            wide = 192 if 136 <= hd <= 192 else 256 if hd >= 200 else 0
            assert inst(hd, 1, code, 1) == inst(hd, 0, code, 1) == narrow
            assert inst(hd, 1, code, 2) == narrow
            assert inst(hd, 0, code, 2) == (narrow or wide)
    assert inst(64, 0, _cuda.DTYPE_CODES[torch.float32], 1) == 0
    assert inst(64, 0, _cuda.DTYPE_CODES[torch.float32], 2) == 0
    keys = _cuda.lib("attention_wgmma").hr_onepass_wgmma_max_keys
    assert (keys(1), keys(2)) == (WA.HELD_MAX_KEYS, WA.SWEEPS_MAX_KEYS)


# the streaming core's wgmma kernels (ops/flash_attention.py
# STREAMING_KERNELS): every instance (hd 32, 64, 96 and 128 on the 128-row
# form, 40 zero-filled to 64; 128, 192 and 256 on the O split, 136
# zero-filled to 192), key lengths past the one-pass limit with a partial
# last 128-key step (2049: one key; 2177; 2249, the 45 s clips)
STREAMING_CASES = [(kernel, hd) for hd in (32, 40, 64, 96, 128, 136, 192, 256)
                   for kernel in FA.streaming_kernels(hd, torch.bfloat16)[1:]]


def _streaming_case(gen, b, h, lq, lk, hd, dtype):
    """(the wrapper called with a kernel, its plain version) on head views of
    [B, L, H*hd] projections, element 1 (where b > 1) with every key
    masked."""
    q = _heads_view(gen, b, lq, h, hd, dtype)
    k, v = (_heads_view(gen, b, lk, h, hd, dtype) for _ in range(2))
    lens = ([lk, 0] + [lk // 3] * b)[:b]
    kb = torch.where(_pad_mask(lens, lk), AB.NEG_INF, 0.0).float()
    return (lambda kernel=None: FA.streaming_attention(q, k, v, kb, kernel),
            lambda: FA.streaming_attention_plain(q, k, v, kb))


def _run_streaming(fn, kernel, hd, forced):
    """One call, counted once on the wrapper and once under its kernel, and
    launched as streaming_wgmma_kernel at its tile instance."""
    wrapper = FA.streaming_attention
    before, by_kernel = wrapper.launches, wrapper.kernels[kernel]
    _cuda.last_kernel("streaming_wgmma")
    got = fn(kernel if forced else None)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and wrapper.kernels[kernel] == by_kernel + 1
    inst = next(t for t in (32, 64, 96, 128, 192, 256) if t >= hd)
    assert _cuda.last_kernel("streaming_wgmma") == ("streaming_wgmma_kernel", inst)
    return got


@pytest.mark.parametrize("kernel,hd", STREAMING_CASES)
@pytest.mark.parametrize("lk", [2049, 2177, 2249])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_streaming_wgmma_kernels(gen, kernel, hd, lk, dtype):
    """Each wgmma kernel of the streaming core, pinned through the wrapper's
    ``kernel``, in bf16 and fp16, Lq not a multiple of 128 (or 64), one
    element with every key masked: within ATTN_TOL of the plain version,
    counted once on its wrapper."""
    fn, plain = _streaming_case(gen, 3, 2, lk - 61, lk, hd, dtype)
    got = _run_streaming(fn, kernel, hd, forced=True)
    assert got.dtype == dtype and torch.isfinite(got).all()
    _close_attention(got, plain())


# row 8 at the paths' and phase 3's shapes, and thin grids: (B, H, L, hd, dtype)
ROUTE_STREAMING = [(2, 8, 2249, 96, torch.bfloat16), (2, 8, 2249, 96, torch.float16),
                   (16, 4, 2267, 64, torch.bfloat16), (16, 8, 2267, 32, torch.bfloat16),
                   (16, 2, 2267, 128, torch.bfloat16), (16, 8, 2267, 40, torch.bfloat16),
                   (2, 4, 2249, 192, torch.bfloat16), (16, 1, 2267, 256, torch.bfloat16),
                   (2, 4, 2049, 64, torch.bfloat16), (2, 2, 2249, 128, torch.bfloat16),
                   (4, 2, 2249, 128, torch.bfloat16), (1, 1, 2249, 256, torch.float16)]


@pytest.mark.parametrize("b,h,l,hd,dtype", ROUTE_STREAMING)
def test_streaming_route_picks_the_fastest(gen, b, h, l, hd, dtype):
    """The kernel ``FA.streaming_kernel`` picks runs, counted under its
    name, within ATTN_TOL of plain, and is the fastest of those that take
    the shape or within STREAMING_ROUTE_MARGIN of it (each timed as
    chip_smoke.py times a row)."""
    from chip_smoke import cuda_ms

    fn, plain = _streaming_case(gen, b, h, l, l, hd, dtype)
    picked = FA.streaming_kernel(l, hd, dtype, b=b, h=h, sms=_cuda.sm_count())
    if picked == "mma":
        before = FA.streaming_attention.kernels["mma"]
        got = fn()
        assert FA.streaming_attention.kernels["mma"] == before + 1
    else:
        got = _run_streaming(fn, picked, hd, forced=False)
    _close_attention(got, plain())
    ms = {kn: cuda_ms(lambda kn=kn: fn(kn), repeats=5) for kn in FA.streaming_kernels(hd, dtype)}
    print(f"{h}x{hd} B={b} L={l} {dtype}: {ms}, picked {picked}")
    assert ms[picked] <= (1 + FA.STREAMING_ROUTE_MARGIN) * min(ms.values()), (picked, ms)


def test_streaming_wgmma_refused_launches_raise(gen):
    """What a wgmma kernel does not take raises from its C entry point,
    never falling back: the 128-row form past 128, the split below 104, fp32;
    and a view TMA cannot describe raises before any launch whatever the
    kernel; the CUDA-core yardstick names no wgmma kernel."""
    def case(hd, dtype):
        return _streaming_case(gen, 2, 2, 64, 2049, hd, dtype)[0]
    for fn, kernel in ((case(136, torch.bfloat16), "wgmma"),
                       (case(64, torch.bfloat16), "wgmma_split"),
                       (case(64, torch.float32), "wgmma"),
                       (case(256, torch.float32), "wgmma_split")):
        with pytest.raises(RuntimeError, match="hr_streaming_wgmma"):
            fn(kernel)
    q = _randn(gen, 1, 2049, 2 * 97, dtype=torch.bfloat16)[..., :192].view(1, 2049, 2, 96) \
        .transpose(1, 2)   # rows 388 bytes apart: no tensor map, no aligned rows
    kb = torch.zeros(1, 2049, device="cuda")
    assert FA.streaming_route(q, q, q) == "mma"
    for kernel in FA.STREAMING_KERNELS:
        with pytest.raises(ValueError, match="16-byte aligned"):
            FA.streaming_attention(q, q, q, kb, kernel)
    q = _heads_view(gen, 1, 2049, 2, 96, torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        FA.streaming_launch(q, q, q, kb, cuda_cores=True, kernel="wgmma")


def test_streaming_wgmma_instances(gen):
    """The C entry point's instances: the 128-row form at 32, 64, 96 and 128
    (hd 8-128), the split at 128, 192 and 256 (hd 104-256), bf16 and fp16
    only."""
    inst = _cuda.lib("streaming_wgmma").hr_streaming_wgmma_instance
    for code in (_cuda.DTYPE_CODES[torch.bfloat16], _cuda.DTYPE_CODES[torch.float16]):
        for hd in range(8, 257, 8):
            tile = next(t for t in (32, 64, 96, 128, 192, 256) if t >= hd)
            assert inst(hd, code, 1) == (tile if tile <= 128 else 0)
            assert inst(hd, code, 2) == (tile if tile >= 128 else 0)
    assert inst(64, _cuda.DTYPE_CODES[torch.float32], 1) == 0
    assert inst(12, _cuda.DTYPE_CODES[torch.bfloat16], 1) == 0


def _ffn_operands(gen, d, f, dtype):
    f32 = torch.float32
    return (_randn(gen, f, d, scale=0.05, dtype=dtype), _randn(gen, f, scale=0.02, dtype=f32),
            _randn(gen, d, f, scale=0.05, dtype=dtype), _randn(gen, d, scale=0.02, dtype=f32),
            1.0 + _randn(gen, d, scale=0.1, dtype=f32), _randn(gen, d, scale=0.1, dtype=f32))


@pytest.mark.parametrize("m", [1, 41, 128, 129, 300, 3992])
@pytest.mark.parametrize("fast_gelu", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ffn_block_bf16(gen, m, fast_gelu, dtype):
    """The float FFN block at WavLM's widths, row counts on each side of a
    128-row GEMM tile and the extraction batch's 3992: bf16 at the sublayer
    tolerance, fp32 at 2e-4 (3xTF32 products and fp32 sums in another
    order)."""
    ops = _ffn_operands(gen, 768, 3072, dtype)
    x = _randn(gen, m, 768, dtype=dtype)
    before = FF.ffn_block_bf16.launches
    got = FF.ffn_block_bf16(x, *ops, 1e-5, fast_gelu)
    torch.cuda.synchronize()
    assert FF.ffn_block_bf16.launches == before + 1
    ref = FF.ffn_block_bf16_plain(x, *ops, 1e-5, fast_gelu)
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=2e-4, rtol=0)
    else:
        _close(got, ref)


def test_ffn_block_bf16_backward(gen):
    """Kernel forward, backward through the unfused reference: the
    gradients of x and W1 equal autograd through the reference."""
    w1, b1, w2, b2, g, b = _ffn_operands(gen, 256, 1024, torch.float32)
    x = _randn(gen, 37, 256, dtype=torch.float32)
    grads = []
    for fn in (FF.ffn_block_bf16, FF.ffn_reference):
        xi, wi = x.clone().requires_grad_(True), w1.clone().requires_grad_(True)
        (fn(xi, wi, b1, w2, b2, g, b, 1e-5, True) ** 2).sum().backward()
        grads.append((xi.grad, wi.grad))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


# (key length, dtype, B, heads, head dim, the one-pass kernel the rule
# picks): the mma.sync two sweeps (B=2 4 x 96: 64 blocks of 128 rows), the
# wgmma sweeps (B=8 4 x 96: 256 blocks; 4 x 192 at B=2 and 1499 keys),
# fp32, streaming
FLASH_BACKWARD = [(1024, torch.float32, 2, 4, 96, "mma"), (1024, torch.bfloat16, 2, 4, 96, "mma"),
                  (1024, torch.bfloat16, 8, 4, 96, "wgmma_sweeps"),
                  (1499, torch.bfloat16, 2, 4, 192, "wgmma_sweeps"),
                  (2049, torch.float32, 2, 4, 96, None), (2049, torch.bfloat16, 2, 4, 96, None)]


@pytest.mark.parametrize("lk,dtype,b,h,hd,kernel", FLASH_BACKWARD)
def test_flash_mha_backward(gen, lk, dtype, b, h, hd, kernel):
    """flash_mha on the card (the kernel forward, on the one-pass kernel the
    rule picks for the shape, or streaming past 2048 keys (a 1-key last
    block); the backward recomputed over 512-key blocks) gives the gradients
    of autograd through its plain version, with padding: fp32 at 1e-4, bf16
    within 5e-2 in relative norm."""
    def heads():
        return _randn(gen, b, lk, h * hd, dtype=dtype).view(b, lk, h, hd).transpose(1, 2)
    q, k, v, g = heads(), heads(), heads(), heads()
    mask = _pad_mask([lk, lk - 300] * (b // 2), lk)
    grads = []
    for fn in (FA.flash_mha, FA.flash_mha_plain):
        before = FA.onepass_attention.kernels[kernel]
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        fn(*ins, mask).backward(g)
        if kernel is not None and fn is FA.flash_mha:
            assert FA.onepass_attention.kernels[kernel] == before + 1
        grads.append([t.grad for t in ins])
    for got, ref in zip(*grads):
        assert torch.isfinite(got).all() and got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
        else:
            assert ((got - ref).float().norm() / ref.float().norm()).item() < 5e-2


def _stack_operands(gen, dtype):
    enc = WavLMEncoder(WavLMConfig(num_hidden_layers=1))
    enc.init_weights(gen)
    enc = enc.to("cuda").eval()
    return enc, CS.stack_operands(enc.feature_extractor, dtype)


@pytest.mark.parametrize("b,tw", [(1, 16000), (2, 400), (3, 2920), (2, 160000), (1, 2580),
                                  (2, 2600), (2, 5200), (1, 10400), (1, 20720), (1, 41360),
                                  (2, 20640), (2, 2565), (2, 2570)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_stack_stages(gen, b, tw, dtype):
    """Each stage against its plain version on the same inputs: B=1 at 1 s;
    400 samples (one output frame, shorter than a tile); 2920 samples (72
    conv3 rows and 8 output frames: both end on a K2 tile); 10 s; and K1's
    convs one row past a 128-row GEMM tile: 2580 samples (t1 = 257), 2600
    (t2 = 129) and 5200 (t3 = 129); K2's the same: 10400 (t4 = 129), 20720
    (t5 = 129), 41360 (t6 = 129) and 20640 (t4 = 257); the stats' chunks of
    256 conv0 rows: 2565 samples (n0 = 512, two whole chunks) and 2570 (one
    row past)."""
    _, (w0, gn_w, gn_b, *taps) = _stack_operands(gen, dtype)
    wave = _randn(gen, b, tw, scale=0.3, dtype=dtype)
    before = [CS.conv_stack_stats.launches, CS.conv_stack_k1.launches, CS.conv_stack_k2.launches]
    stats = CS.conv_stack_stats(wave, w0)
    torch.testing.assert_close(stats, CS.conv_stack_stats_plain(wave, w0), rtol=1e-4, atol=1e-2)
    x3 = CS.conv_stack_k1(wave, stats, w0, gn_w, gn_b, *taps[:3], 1e-5, True)
    ref3 = CS.conv_stack_k1_plain(wave, stats, w0, gn_w, gn_b, *taps[:3], 1e-5, True)
    out = CS.conv_stack_k2(ref3, *taps[3:], True)
    ref = CS.conv_stack_k2_plain(ref3, *taps[3:], True)
    torch.cuda.synchronize()
    assert [CS.conv_stack_stats.launches, CS.conv_stack_k1.launches,
            CS.conv_stack_k2.launches] == [n + 1 for n in before]
    lens = CS.conv_lengths(tw)
    assert x3.shape == (b, lens[3], 512) and out.shape == (b, lens[6], 512)
    for got, want in ((x3, ref3), (out, ref)):
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        else:
            _close(got, want)


def _served_conv_shapes():
    """(B, t_in, k) of conv1..6 at each served (bucket, batch), the batch cut
    to 8 at most, and at B = 1 at 1 s."""
    shapes = []
    for sec, b in sorted(MEASURED_BUCKET_BATCH.items()) + [(1.0, 1)]:
        lens = CS.conv_lengths(int(sec * 16000))
        shapes += [(min(b, 8), t_in, k) for t_in, k in zip(lens[:6], CS.KERNEL[1:])]
    return shapes


def _conv_gemm_check(gen, b, t_in, k, bn=None):
    x = _randn(gen, b, t_in, 512)
    taps = _randn(gen, k, 512, 512, scale=(2.0 / (k * 512)) ** 0.5)
    before = CS.conv_gemm.launches
    got = CS.conv_gemm(x, taps, True, bn=bn)
    ref = CS._conv_s2(x, taps, True)
    torch.cuda.synchronize()
    assert CS.conv_gemm.launches == before + 1
    assert got.shape == ref.shape == (b, (t_in - k) // 2 + 1, 512)
    _close(got, ref)


@pytest.mark.parametrize("b,t_in,k", _served_conv_shapes())
def test_conv_gemm_at_the_served_shapes(gen, b, t_in, k):
    """The bf16 TMA GEMM (csrc/tma_gemm.cuh) against the plain stride-2 conv
    at every conv's shape of the served pairs, on the tile the plan picks."""
    _conv_gemm_check(gen, b, t_in, k)


@pytest.mark.parametrize("b,t_in,k", [
    (1, 257, 3), (1, 258, 2),    # 128 output rows: one whole tile
    (2, 259, 3), (2, 258, 3),    # 129 and 128 rows of an odd and an even t_in
    (3, 255, 3), (3, 254, 2),    # 127 rows: one short of a tile; the next element's rows
    (3, 260, 2), (2, 517, 3),    # 130 and 258 rows: a tile runs past each element's end
    (1, 4, 3), (5, 3, 2),        # one output row
])
@pytest.mark.parametrize("bn", [128, 256])
def test_conv_gemm_at_tile_edges(gen, b, t_in, k, bn):
    """Each column tile at output lengths around the 128-row tile, with
    batch elements whose rows a tile runs past (the maps' batch dimension
    must give zeros there, the output map must not store them), odd and
    even t_in (the even-row map one row longer than the odd-row one)."""
    _conv_gemm_check(gen, b, t_in, k, bn)


def test_conv_gemm_refused_launch_raises(gen):
    """What the TMA GEMM does not take raises, in the wrapper or from the C
    entry's error code, and nothing falls back to another pipeline."""
    x = _randn(gen, 2, 259, 512)
    taps = _randn(gen, 3, 512, 512, scale=0.03)
    with pytest.raises(ValueError):     # no 64-column instance
        CS.conv_gemm(x, taps, True, bn=64)
    with pytest.raises(TypeError):      # bf16 only
        CS.conv_gemm(x.float(), taps.float(), True)
    with pytest.raises(ValueError):     # a strided view is refused, not copied
        CS.conv_gemm(x[:, ::2], taps, True)
    with pytest.raises(ValueError):     # four taps
        CS.conv_gemm(x, _randn(gen, 4, 512, 512), True)
    out = torch.empty((2, 129, 512), dtype=torch.bfloat16, device="cuda")
    lib = _cuda.lib("conv_stack")
    before = CS.conv_gemm.launches
    for m, bn, grid in ((129, 64, 132), (129, 256, 0), (128, 256, 132)):
        with pytest.raises(RuntimeError):
            _cuda.check(lib.hr_conv_s2_tma(x.data_ptr(), 2, 259, 3, taps.data_ptr(), m, 1, bn,
                                           grid, out.data_ptr(), _cuda.stream()),
                        "hr_conv_s2_tma")
    with pytest.raises(ValueError):     # an output of another length
        CS._conv_gemm_into(x, taps, True, out[:, :128].contiguous())
    assert CS.conv_gemm.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_stack_convs_launch_the_tma_gemm(gen, dtype):
    """In bf16 K1's three convs and K2's launch the TMA GEMM, one launch
    each; the cp.async GEMM, forced as the yardstick, launches none and
    agrees with it; fp32 keeps its 3xTF32 pipeline."""
    _, (w0, gn_w, gn_b, *taps) = _stack_operands(gen, dtype)
    wave = _randn(gen, 2, 40000, scale=0.3, dtype=dtype)
    stats = CS.conv_stack_stats(wave, w0)
    before = CS.conv_gemm.launches
    x3 = CS.conv_stack_k1(wave, stats, w0, gn_w, gn_b, *taps[:3], 1e-5, True)
    out = CS.conv_stack_k2(x3, *taps[3:], True)
    per_stage = 3 if dtype == torch.bfloat16 else 0
    assert CS.conv_gemm.launches == before + 2 * per_stage
    x3p = CS._conv_launches(CS._conv0_launch(wave, stats, w0, gn_w, gn_b, 1e-5, True),
                            taps[:3], True, cp_async=True)
    outp = CS._conv_launches(x3, taps[3:], True, cp_async=True)
    torch.cuda.synchronize()
    assert CS.conv_gemm.launches == before + 2 * per_stage
    for got, ref in ((x3, x3p), (out, outp)):
        if dtype == torch.float32:
            assert torch.equal(got, ref)
        else:
            _close(got, ref)


@pytest.mark.parametrize("b,t_in,k", [(8, 3999, 3), (8, 1999, 3), (5, 259, 3), (3, 260, 2)])
@pytest.mark.parametrize("bn", [128, 256])
def test_conv_gemm_stores_every_tile(gen, b, t_in, k, bn):
    """Twenty launches in a row, each into an output filled with NaN: every
    element is stored every time (a tile left unstored would keep its NaN,
    where an output from the caching allocator would hide it behind an
    earlier launch's values) and holds the plain version's tolerance."""
    x = _randn(gen, b, t_in, 512)
    taps = _randn(gen, k, 512, 512, scale=(2.0 / (k * 512)) ** 0.5)
    ref = CS._conv_s2(x, taps, True)
    for _ in range(20):
        got = CS._conv_gemm_into(x, taps, True, torch.full_like(ref, float("nan")), bn)
        torch.cuda.synchronize()
        assert not got.isnan().any()
        _close(got, ref)


def test_conv_stack_k1_shorter_than_a_tile(gen):
    _, (w0, gn_w, gn_b, *taps) = _stack_operands(gen, torch.float32)
    wave = _randn(gen, 2, 300, scale=0.3, dtype=torch.float32)  # 6 conv3 rows
    stats = CS.conv_stack_stats(wave, w0)
    got = CS.conv_stack_k1(wave, stats, w0, gn_w, gn_b, *taps[:3], 1e-5, False)
    assert got.shape == (2, 6, 512)
    torch.testing.assert_close(
        got, CS.conv_stack_k1_plain(wave, stats, w0, gn_w, gn_b, *taps[:3], 1e-5, False),
        atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_stack_k1_workspace_reuse(gen, dtype):
    """K1's conv workspaces come from the caching allocator: calls of other
    lengths in turn (each reusing the blocks the last one freed, longer or
    shorter) still match their plain versions."""
    _, (w0, gn_w, gn_b, *taps) = _stack_operands(gen, dtype)
    for tw in (48000, 16000, 32000, 16000):
        wave = _randn(gen, 2, tw, scale=0.3, dtype=dtype)
        stats = CS.conv_stack_stats(wave, w0)
        got = CS.conv_stack_k1(wave, stats, w0, gn_w, gn_b, *taps[:3], 1e-5, True)
        ref = CS.conv_stack_k1_plain(wave, stats, w0, gn_w, gn_b, *taps[:3], 1e-5, True)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
        else:
            _close(got, ref)
        del got, ref


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_stack_k2_workspace_reuse(gen, dtype):
    """K2's conv4 and conv5 workspaces come from the caching allocator:
    calls of other lengths in turn still match their plain versions."""
    _, (*_, w4, w5, w6) = _stack_operands(gen, dtype)
    for t3 in (1033, 259, 517, 259):
        x3 = _randn(gen, 2, t3, 512, dtype=dtype)
        got = CS.conv_stack_k2(x3, w4, w5, w6, True)
        ref = CS.conv_stack_k2_plain(x3, w4, w5, w6, True)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
        else:
            _close(got, ref)
        del got, ref


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_stack_stats_same_bits_every_call(gen, dtype):
    """The stats add their chunks' partial sums in a fixed order, with no
    atomics: two calls on 8 x 10 s give the same bits (K1's output depends
    on them)."""
    _, (w0, *_) = _stack_operands(gen, dtype)
    wave = _randn(gen, 8, 160000, scale=0.3, dtype=dtype)
    first = CS.conv_stack_stats(wave, w0)
    second = CS.conv_stack_stats(wave, w0)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    torch.testing.assert_close(first, CS.conv_stack_stats_plain(wave, w0), rtol=1e-4, atol=1e-2)
    # n0 one row short of, on, and one past a chunk (STATS_ROWS) and a
    # 16-row tile of the tensor-core kernel, each Tw at both ends of its n0
    # (the last sample read, and four past it), at B = 3 so that one element's
    # chunk ends where the next begins
    for n0 in (15, 16, 17, CS.STATS_ROWS - 1, CS.STATS_ROWS, CS.STATS_ROWS + 1,
               2 * CS.STATS_ROWS + 1):
        for tw in (5 * (n0 - 1) + 10, 5 * (n0 - 1) + 14):
            assert CS.conv_lengths(tw)[0] == n0
            wave = _randn(gen, 3, tw, scale=0.3, dtype=dtype)
            first = CS.conv_stack_stats(wave, w0)
            second = CS.conv_stack_stats(wave, w0)
            torch.cuda.synchronize()
            assert torch.equal(first, second), (n0, tw)
            torch.testing.assert_close(first, CS.conv_stack_stats_plain(wave, w0), rtol=1e-4,
                                       atol=1e-2)
            if dtype == torch.bfloat16:  # the parent's CUDA-core kernel agrees as well
                torch.testing.assert_close(CS._stats_launch(wave, w0, cuda_cores=True), first,
                                           rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_stack_stats_batch_16(gen, dtype):
    """B = 16 on the grid's batch axis, 2.5 s clips."""
    _, (w0, *_) = _stack_operands(gen, dtype)
    wave = _randn(gen, 16, 40000, scale=0.3, dtype=dtype)
    got = CS.conv_stack_stats(wave, w0)
    torch.testing.assert_close(got, CS.conv_stack_stats_plain(wave, w0), rtol=1e-4, atol=1e-2)


def test_conv_stack_fused_matches_routed_encoder(gen):
    """fp32 against the routed cuDNN feature encoder with TF32 off, at
    tests/test_conv_stack.py's 2e-4/2e-3."""
    enc, _ = _stack_operands(gen, torch.float32)
    wave = _randn(gen, 2, 40000, scale=0.3, dtype=torch.float32)
    with torch.no_grad():
        ref = enc._feature_encoder(wave)
        got = CS.conv_stack_fused(enc.feature_extractor, wave, enc.config)
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=2e-3)


def _served_encoder(gen):
    """WavLM base-plus's feature encoder as served: bf16, tanh GELU (one
    transformer layer)."""
    enc = WavLMEncoder(WavLMConfig(num_hidden_layers=1, fast_gelu=True))
    enc.init_weights(gen)
    return enc.to("cuda", torch.bfloat16).eval()


@pytest.mark.parametrize("sec,b", sorted(MEASURED_BUCKET_BATCH.items()))
def test_conv_stack_route_at_the_served_pairs(gen, sec, b):
    """At each served (bucket, batch), bf16: stats + K1 + K2 against the
    cuDNN route, each timed as chip_smoke.py times a row (a CUDA graph of
    calls, the median of 5 replays). The route the rule picks is the faster,
    or within ROUTE_NOISE (2%) and ROUTE_NOISE_MS (1 us) of it; the kernels'
    output is within the bf16 envelope (EXTRACT_ENVELOPE) of the route's."""
    from chip_smoke import EXTRACT_ENVELOPE, ROUTE_NOISE, ROUTE_NOISE_MS, cuda_ms

    enc = _served_encoder(gen)
    tw = int(sec * 16000)
    wave = _randn(gen, b, tw, scale=0.1)
    routes = {"fused": lambda: CS.conv_stack_fused(enc.feature_extractor, wave, enc.config),
              "cudnn": lambda: enc._cudnn_convs(wave[:, None, :], range(7), wave).transpose(
                  1, 2).contiguous()}
    with torch.no_grad():
        got, ref = routes["fused"](), routes["cudnn"]()
        torch.testing.assert_close(got.float(), ref.float(), **EXTRACT_ENVELOPE)
        iters = max(3, min(20, int(2e8 // (b * tw))))
        ms = {r: cuda_ms(fn, iters=iters, repeats=5) for r, fn in routes.items()}
    picked = CS.conv_stack_route("cuda", torch.bfloat16, b, tw)
    other = "cudnn" if picked == "fused" else "fused"
    print(f"{sec} s B={b}: {ms}, picked {picked}")
    assert ms[picked] <= (1 + ROUTE_NOISE) * ms[other] + ROUTE_NOISE_MS, (picked, ms)


def test_wavlm_forward_launches_the_conv_stack_once(gen):
    """A bf16 WavLM forward on the card launches stats, K1 and K2 once each
    (one fused route decision); with use_kernels=False it runs their plain
    versions, launching none, within the sublayer tolerance; an fp32 forward
    stays on the cuDNN route."""
    from hriemo_torch.nn.layers import set_use_kernels

    enc = _served_encoder(gen)
    wave = _randn(gen, 4, 40000, scale=0.1)
    mask = torch.ones(4, 40000, dtype=torch.int32, device="cuda")
    mask[1, 30000:] = 0
    counters = (CS.conv_stack_stats, CS.conv_stack_k1, CS.conv_stack_k2)

    def forward(model, w):
        before = [c.launches for c in counters]
        fused = CS.use_conv_stack.routes["fused", 4, 40000, str(w.dtype)[6:]]
        with torch.no_grad():
            out, _ = model(w, mask)
        torch.cuda.synchronize()
        return out, [c.launches - n for c, n in zip(counters, before)], \
            CS.use_conv_stack.routes["fused", 4, 40000, str(w.dtype)[6:]] - fused

    out, launches, fused = forward(enc, wave)
    assert launches == [1, 1, 1] and fused == 1
    plain, launches, fused = forward(set_use_kernels(copy.deepcopy(enc), False), wave)
    assert launches == [0, 0, 0] and fused == 1
    _close(out, plain)
    _, launches, fused = forward(copy.deepcopy(enc).float(), wave.float())
    assert launches == [0, 0, 0] and fused == 0


def test_conv_stack_prepared_operands_bit_equal(gen):
    """The operands prepared once give the same bits as the ones a call
    took before (stack_operands), and so does the stack on them."""
    enc = _served_encoder(gen)
    fe = enc.feature_extractor
    wave = _randn(gen, 3, 40000, scale=0.1)
    prepared = CS.prepared_operands(fe, torch.bfloat16)
    fresh = CS.stack_operands(fe, torch.bfloat16)
    assert CS.prepared_operands(fe, torch.bfloat16) is prepared
    for a, b in zip(prepared, fresh):
        assert a.dtype == b.dtype and torch.equal(a, b)
    w0, gn_w, gn_b, *taps = fresh
    with torch.no_grad():
        got = CS.conv_stack_fused(fe, wave, enc.config)
        x3 = CS.conv_stack_k1(wave, CS.conv_stack_stats(wave, w0), w0, gn_w, gn_b, *taps[:3],
                              enc.config.layer_norm_eps, True)
        want = CS.conv_stack_k2(x3, *taps[3:], True)
    assert torch.equal(got, want)


def test_new_kernels_raise_instead_of_falling_back(gen):
    w1, b1, w2, b2, g, b = _ffn_operands(gen, 256, 1024, torch.bfloat16)
    x = _randn(gen, 8, 256)
    with pytest.raises(TypeError):      # half precision is not a dtype of the kernel
        FF.ffn_block_bf16(x.half(), w1.half(), b1, w2.half(), b2, g, b)
    with pytest.raises(ValueError):     # a strided view is refused, not copied
        FF.ffn_block_bf16(_randn(gen, 256, 16).t(), w1, b1, w2, b2, g, b)
    with pytest.raises(ValueError):     # weights on the CPU
        FF.ffn_block_bf16(x, w1.cpu(), b1, w2, b2, g, b)
    _, (w0, gn_w, gn_b, *taps) = _stack_operands(gen, torch.float32)
    wave = _randn(gen, 2, 16000, dtype=torch.float32)
    with pytest.raises(TypeError):
        CS.conv_stack_stats(wave.half(), w0.half())
    with pytest.raises(ValueError):
        CS.conv_stack_stats(_randn(gen, 2, 32000, dtype=torch.float32)[:, ::2], w0)
    stats = CS.conv_stack_stats(wave, w0)
    with pytest.raises(ValueError):     # statistics on the CPU
        CS.conv_stack_k1(wave, stats.cpu(), w0, gn_w, gn_b, *taps[:3], 1e-5, True)
    with pytest.raises(TypeError):      # bf16 weights for an fp32 waveform
        CS.conv_stack_k1(wave, stats, w0, gn_w, gn_b, taps[0].bfloat16(), *taps[1:3], 1e-5, True)
    x3 = CS.conv_stack_k1(wave, stats, w0, gn_w, gn_b, *taps[:3], 1e-5, True)
    with pytest.raises(ValueError):
        CS.conv_stack_k2(x3.transpose(0, 1), *taps[3:], True)
    with pytest.raises(ValueError):
        CS.conv_stack_k2(x3, taps[3].cpu(), *taps[4:], True)


# ------------------------------------------- evaluation and inference paths

def test_bridges_on_the_card(gen):
    """HF-layout state dicts of the tiny frontends (``chip_smoke.
    hf_state_dict``) load through the bridges; on the card the loaded
    encoders give the source modules' outputs, within the rounding of the
    weight-norm fold (WavLM) or bit for bit (BERT)."""
    from hriemo_torch.frontends import BertConfig, BertEncoder
    from chip_smoke import hf_state_dict

    wavlm = WavLMEncoder(WavLMConfig.tiny())
    wavlm.init_weights(gen)
    bert = BertEncoder(BertConfig.tiny())
    bert.init_weights(gen)
    w2 = WavLMEncoder(WavLMConfig.tiny()).from_torch_state_dict(hf_state_dict(wavlm, "wavlm."))
    b2 = BertEncoder(BertConfig.tiny()).from_torch_state_dict(hf_state_dict(bert, "bert."))
    wav = _randn(gen, 2, 4000, dtype=torch.float32)
    wmask = _pad_mask([4000, 2500], 4000).logical_not().int()
    ids = torch.randint(0, 99, (2, 16), generator=gen).cuda()
    tmask = _pad_mask([16, 9], 16).logical_not().int()
    with torch.no_grad():
        ref_a, ref_m = wavlm.cuda().eval()(wav, wmask)
        got_a, got_m = w2.cuda().eval()(wav, wmask)
        ref_t = bert.cuda().eval()(ids, tmask)
        got_t = b2.cuda().eval()(ids, tmask)
    torch.testing.assert_close(got_m, ref_m, atol=0, rtol=0)
    torch.testing.assert_close(got_a, ref_a, atol=1e-5, rtol=1e-5)
    for g, r in zip(got_t, ref_t):
        torch.testing.assert_close(g, r, atol=0, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_need_weights_launches_no_fused_kernel(gen, int8):
    """A call that takes ``flash_mha`` (float, 1024 keys) or the int8 MHA
    kernel (int8, 499 keys) launches neither with ``need_weights``: the
    weights come from the per-op route."""
    mha = MultiheadAttention(768, 8)
    init_torch_defaults(mha, gen)
    mha = mha.to("cuda", torch.bfloat16).eval()
    if int8:
        quantize_for_serving(mha, min_dim=128)
    x = _randn(gen, 2, 499 if int8 else 1024, 768)
    counters = (AB.mha_block_int8, FA.onepass_attention, FA.streaming_attention)
    with torch.no_grad():
        for fn in counters:
            fn.launches = 0
        out, w = mha(x, x, x, need_weights=True)
        assert [fn.launches for fn in counters] == [0, 0, 0]
        fused = mha(x, x, x)
        assert (AB.mha_block_int8 if int8 else FA.onepass_attention).launches == 1
    assert w.shape == (2, x.shape[1], x.shape[1]) and w.dtype == torch.bfloat16
    torch.testing.assert_close(w.float().sum(-1), torch.ones(2, x.shape[1], device="cuda"),
                               atol=2e-2, rtol=0)
    _close(out, fused)


def _mosei_checkpoint(tmp_path, gen, max_la, cap, n=24):
    """A random-weight MOSEI checkpoint at the trainer's defaults, trained
    (its ``args`` say) at the audio cap ``cap``, and a synthetic corpus up
    to ``max_la`` audio frames."""
    from hriemo_torch.data.synthetic import make_synthetic_mosei
    from hriemo_torch.models import MoseiFusionWithEmotionDecoder
    from hriemo_torch.utils.checkpoint import save_torch_checkpoint

    csv_path, audio_dir, text_dir = make_synthetic_mosei(tmp_path / "data", n=n,
                                                         max_la=max_la, max_lt=64)
    model = MoseiFusionWithEmotionDecoder(74, 300)
    model.init_weights(gen)
    ckpt = tmp_path / "ckpt.pt"
    save_torch_checkpoint(str(ckpt), {"model_state_dict": model.state_dict(), "args": {
        "d_model": 256, "n_heads": 4, "max_len_audio": cap, "max_len_text": 0}})
    return ["--ckpt", str(ckpt), "--index_csv", str(csv_path), "--audio_dir", str(audio_dir),
            "--text_dir", str(text_dir), "--splits", "val", "test", "--batch_size", "4",
            "--out_dir", str(tmp_path / "out")]


def test_mosei_eval_fp16_at_300_frames(gen, tmp_path):
    """``--amp_dtype fp16`` at the default cap of 300 frames runs per op."""
    import numpy as np

    from hriemo_torch.infer import mosei_eval_infer as EVAL

    argv = _mosei_checkpoint(tmp_path, gen, 600, cap=300)
    EVAL.main(argv + ["--amp_dtype", "fp16", "--dump_beta", "--dump_attn"])
    probs = np.load(tmp_path / "out" / "val_y_prob.npy")
    assert probs.shape[1] == 6 and np.isfinite(probs).all()


def test_mosei_eval_fp16_at_flash_lengths(gen, tmp_path):
    """Uncapped at 1100-2200 frames the audio self-attention takes
    ``flash_mha``, whose one-pass and streaming kernels run fp16 as JAX runs
    it: probabilities within 0.01 of the same CLI on the plain versions."""
    import numpy as np

    from hriemo_torch.infer import mosei_eval_infer as EVAL

    argv = _mosei_checkpoint(tmp_path, gen, 2200, cap=0, n=8)
    FA.onepass_attention.launches = FA.streaming_attention.launches = 0
    EVAL.main(argv + ["--amp_dtype", "fp16"])
    assert FA.onepass_attention.launches + FA.streaming_attention.launches > 0
    plain = [a if a != str(tmp_path / "out") else str(tmp_path / "plain") for a in argv]
    EVAL.main(plain + ["--amp_dtype", "fp16"], use_kernels=False)
    for split in ("val", "test"):
        got = np.load(tmp_path / "out" / f"{split}_y_prob.npy")
        ref = np.load(tmp_path / "plain" / f"{split}_y_prob.npy")
        assert np.isfinite(got).all() and np.abs(got - ref).max() <= 1e-2


# the MOSEI model's d=256 in 8 heads (hd 32), uncapped: one-pass up to 2048
# keys, streaming beyond, with padding; the tile instance at 32 and, as a
# yardstick, the CUDA-core kernel that served hd 32 before it
@pytest.mark.parametrize("lk", [1951, 2267])
@pytest.mark.parametrize("dtype", ATTN_DTYPES)
def test_flash_fallbacks_at_head_dim_32(gen, lk, dtype):
    b, h, hd = 4, 8, 32
    q, k, v = (_heads_view(gen, b, lk, h, hd, dtype) for _ in range(3))
    bias = FA.key_bias(_pad_mask([lk, lk - 235, lk - 330, 1], lk), b, lk, q.device)
    fn = FA.onepass_attention if lk <= FA.ONEPASS_MAX_LK else FA.streaming_attention
    plain = getattr(FA, fn.__name__ + "_plain")
    cuda_cores = WA.onepass_launch if fn is FA.onepass_attention else FA.streaming_launch
    ref = plain(q, k, v, bias)
    for got in (fn(q, k, v, bias), cuda_cores(q, k, v, bias, cuda_cores=True)):
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.isfinite(got).all()
        _close_attention(got, ref)


@pytest.mark.parametrize("dtype,kernel", [
    (dt, kernel) for dt in ATTN_DTYPES for kernel in (None, "mma", "wgmma", "wgmma_sweeps")
    if dt != torch.float32 or kernel in (None, "mma")])
@pytest.mark.parametrize("l", [499, 130])
def test_wavlm_fused_attention_gradient_bit_equal(gen, dtype, l, kernel):
    """The kernel forward (the rule's, or each kernel pinned) recomputes
    through the plain version in its backward and never reads the kernel's
    output: every gradient (q, k, v, gate, position_bias, key_padding_bias)
    equals autograd through the plain version bit for bit."""
    b, h, hd = 2, 12, 64
    q, k, v = (_heads_view(gen, b, l, h, hd, dtype) for _ in range(3))
    gate = (torch.rand(b, h, l, generator=gen) * 1.5 + 0.5).to("cuda", dtype)
    pos = _randn(gen, h, l, l, scale=0.3, dtype=dtype)
    kb = torch.where(_pad_mask([l, l - 77], l), AB.NEG_INF, 0.0).float()
    g = _randn(gen, b, h, l, hd, dtype=dtype)
    grads = []
    fused = lambda *a: WA.wavlm_fused_attention(*a, kernel=kernel)
    for fn in (fused, WA.wavlm_fused_attention_plain):
        ins = [t.detach().requires_grad_(True) for t in (q, k, v, gate, pos, kb)]
        before = WA.wavlm_fused_attention.launches
        out = fn(*ins)
        assert WA.wavlm_fused_attention.launches == before + (fn is fused)
        grads.append(torch.autograd.grad(out, ins, g))
    for got, ref in zip(*grads):
        assert got.dtype == ref.dtype and torch.isfinite(got).all()
        assert torch.equal(got, ref)


# ---------------------------------------------------------------- CUDA graphs
# StreamingPipeline replays one captured graph per input signature; a
# replay must give the eager forward's bits, and a flush's result must
# survive the next replay of its graph (d=256, 2 layers: the int8 kernels
# and the bf16 fused WavLM core at 199 frames).

def _graph_models(gen):
    from hriemo_torch import bench
    from hriemo_torch.frontends.bert import BertConfig

    wc = WavLMConfig.tiny(hidden_size=256, num_attention_heads=4, intermediate_size=512,
                          num_hidden_layers=2, fast_gelu=True)
    bc = BertConfig.tiny(vocab_size=30522, hidden_size=256, num_attention_heads=4,
                         intermediate_size=512, num_hidden_layers=2, fast_gelu=True)
    fusion = dict(d_model=256, num_emotions=4, n_heads=8, num_layers_fusion=1,
                  num_layers_decoder=1, beta_hidden=128)
    return bench.build_serving_models(int(torch.randint(0, 1 << 30, (1,), generator=gen)),
                                      (wc, bc, fusion))


def _graph_models_base_convs(gen):
    """``_graph_models`` with WavLM on the base conv pattern at 512 channels,
    which bf16 routes to the conv-stack kernels."""
    from hriemo_torch import bench
    from hriemo_torch.frontends.bert import BertConfig

    wc = WavLMConfig.tiny(hidden_size=256, num_attention_heads=4, intermediate_size=512,
                          num_hidden_layers=2, fast_gelu=True, conv_dim=(512,) * 7,
                          conv_kernel=CS.KERNEL, conv_stride=CS.STRIDE)
    bc = BertConfig.tiny(vocab_size=30522, hidden_size=256, num_attention_heads=4,
                         intermediate_size=512, num_hidden_layers=2, fast_gelu=True)
    fusion = dict(d_model=256, num_emotions=4, n_heads=8, num_layers_fusion=1,
                  num_layers_decoder=1, beta_hidden=128)
    return bench.build_serving_models(int(torch.randint(0, 1 << 30, (1,), generator=gen)),
                                      (wc, bc, fusion))


def _graph_pipe(models, int8, graphs):
    from hriemo_torch import bench

    return bench.serving_pipeline(models, "cuda", int8=int8, buckets=(0.125, 0.25),
                                  max_tokens=64, cuda_graphs=graphs)


def _graph_clips(gen, n):
    import numpy as np

    rng = np.random.default_rng(int(torch.randint(0, 1 << 30, (1,), generator=gen)))
    return [((rng.standard_normal(int(rng.uniform(0.13, 0.25) * 16000)) * 3000)
             .astype(np.int16), "happy sad angry neutral really very", f"c{i}")
            for i in range(n)]


@pytest.mark.parametrize("int8", [True, False])
def test_graph_replay_matches_eager(gen, int8):
    models = _graph_models(gen)
    graphed, eager = _graph_pipe(models, int8, True), _graph_pipe(models, int8, False)
    clips = _graph_clips(gen, 6)
    waves, texts = [c[0] for c in clips], [c[1] for c in clips]
    want = eager.infer(waves, texts)
    for _ in range(2):  # the capture's first replay, then a later one
        got = graphed.infer(waves, texts)
        for g, w in zip(got, want):
            assert g.shape == w.shape and (g == w).all()
    assert len(graphed._graphs) == 1 and not eager._graphs


@pytest.mark.parametrize("int8", [True, False])
def test_graph_replay_runs_the_conv_stack(gen, int8):
    """The conv-stack kernels capture into the pipeline's one graph per input
    signature (their workspaces from the caching allocator, their operands
    prepared in the eager warm-up) and replay it: the eager forward's bits,
    twice, and no launch counted after the capture."""
    models = _graph_models_base_convs(gen)
    graphed, eager = _graph_pipe(models, int8, True), _graph_pipe(models, int8, False)
    clips = _graph_clips(gen, 6)
    waves, texts = [c[0] for c in clips], [c[1] for c in clips]
    before = CS.conv_stack_k1.launches
    want = eager.infer(waves, texts)
    assert CS.conv_stack_k1.launches == before + 1
    for i in range(3):  # the capture (warm-up and capture: two calls), then replays
        got = graphed.infer(waves, texts)
        assert CS.conv_stack_k1.launches == before + 3
        for g, w in zip(got, want):
            assert g.shape == w.shape and (g == w).all()
    assert len(graphed._graphs) == 1


def test_back_to_back_flushes_keep_their_results(gen):
    """Three flushes of one bucket and one text bucket replay one graph back
    to back; each flush's probabilities and beta (read one flush later) are
    its own."""
    models = _graph_models(gen)
    graphed, eager = _graph_pipe(models, True, True), _graph_pipe(models, True, False)
    clips = _graph_clips(gen, 12)
    batch = {0.125: 4, 0.25: 4}
    got = {u: (p, b) for ps, bs, us in graphed.stream_bucketed(clips, bucket_batch=batch,
                                                               pad_flush=True)
           for u, p, b in zip(us, ps, bs)}
    want = {u: (p, b) for ps, bs, us in eager.stream_bucketed(clips, bucket_batch=batch,
                                                              pad_flush=True)
            for u, p, b in zip(us, ps, bs)}
    assert len(graphed._graphs) == 1 and sorted(got) == sorted(want)
    for u in want:
        assert (got[u][0] == want[u][0]).all() and (got[u][1] == want[u][1]).all(), u


def test_a_capture_that_syncs_raises(gen):
    from hriemo_torch.infer.streaming import capture_graph

    x = _randn(gen, 8, dtype=torch.float32)
    with pytest.raises(RuntimeError):
        capture_graph(lambda t: t * float(t.sum()), [x], torch.cuda.graph_pool_handle())
