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

import pytest
import torch

from hriemo_torch.frontends.wavlm import WavLMAttention, WavLMConfig, WavLMEncoder
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


@pytest.mark.parametrize("fast_gelu", [True, False])
@pytest.mark.parametrize("m", [1, 63, 300])
@pytest.mark.parametrize("dtype", ACT_DTYPES)
def test_ffn_block(gen, m, fast_gelu, dtype):
    pair = _quantized(MLP2(256, 1024, 256), gen)
    ops = FF.FfnOperands(pair.ops, _randn(gen, 256, dtype=torch.float32).abs(),
                         _randn(gen, 256, scale=0.1, dtype=torch.float32))
    x = _randn(gen, m, 256, dtype=dtype)
    got = FF.ffn_block_int8(x, ops, 1e-5, fast_gelu)
    assert got.dtype == dtype
    _close(got, FF.ffn_block_int8_plain(x, ops, 1e-5, fast_gelu))


@pytest.mark.parametrize("din,f,dout,m", [(256, 1024, 256, 97), (1024, 256, 768, 3)])
@pytest.mark.parametrize("dtype", ACT_DTYPES)
def test_mlp2(gen, din, f, dout, m, dtype):
    ops = _quantized(MLP2(din, f, dout), gen).ops
    x = _randn(gen, m, din, dtype=dtype)
    got = FF.mlp2_int8(x, ops)
    assert got.dtype == dtype
    _close(got, FF.mlp2_int8_plain(x, ops))


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
    at hd; reading the record clears it."""
    b, h, l = 2, 2, 80
    wide, narrow = ("attn_tf32_wide_kernel", "attn_tf32_kernel") if dtype == torch.float32 \
        else ("streaming_wide_kernel", "streaming_mma_kernel")
    for hd, inst in ((40, 64), (128, 128), (136, 192), (256, 256)):
        q, k, v = (_heads_view(gen, b, l, h, hd, dtype) for _ in range(3))
        kb = torch.zeros(b, l, device="cuda")
        _cuda.last_kernel("flash_attention")
        FA.streaming_attention(q, k, v, kb)
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


@pytest.mark.parametrize("lk", [1024, 2049])   # one-pass; streaming, a 1-key last block
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_mha_backward(gen, lk, dtype):
    """flash_mha on the card (the kernel forward, the backward recomputed
    over 512-key blocks) gives the gradients of autograd through its plain
    version, with padding: fp32 at 1e-4, bf16 within 5e-2 in relative norm."""
    def heads():
        return _randn(gen, 2, lk, 4 * 96, dtype=dtype).view(2, lk, 4, 96).transpose(1, 2)
    q, k, v, g = heads(), heads(), heads(), heads()
    mask = _pad_mask([lk, lk - 300], lk)
    grads = []
    for fn in (FA.flash_mha, FA.flash_mha_plain):
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        fn(*ins, mask).backward(g)
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


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
@pytest.mark.parametrize("l", [499, 130])
def test_wavlm_fused_attention_gradient_bit_equal(gen, dtype, l):
    """The kernel forward's backward recomputes through the plain version
    and never reads the kernel's output: every gradient (q, k, v, gate,
    position_bias, key_padding_bias) equals autograd through the plain
    version bit for bit."""
    b, h, hd = 2, 12, 64
    q, k, v = (_heads_view(gen, b, l, h, hd, dtype) for _ in range(3))
    gate = (torch.rand(b, h, l, generator=gen) * 1.5 + 0.5).to("cuda", dtype)
    pos = _randn(gen, h, l, l, scale=0.3, dtype=dtype)
    kb = torch.where(_pad_mask([l, l - 77], l), AB.NEG_INF, 0.0).float()
    g = _randn(gen, b, h, l, hd, dtype=dtype)
    grads = []
    for fn in (WA.wavlm_fused_attention, WA.wavlm_fused_attention_plain):
        ins = [t.detach().requires_grad_(True) for t in (q, k, v, gate, pos, kb)]
        before = WA.wavlm_fused_attention.launches
        out = fn(*ins)
        assert WA.wavlm_fused_attention.launches == before + (fn is WA.wavlm_fused_attention)
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
