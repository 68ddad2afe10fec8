"""Kernels K1, K2, K3 on the card against their plain versions, and the
wrappers' contract on CUDA tensors. Marked ``cuda``: each test skips without
a card. This file imports neither JAX nor demucs_tpu, so it runs on a machine
without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1/K2 1e-4 x peak (an fp32 FFT against fp32 dense DFT products,
sums of thousands of terms), K3 atol 2e-5 rtol 1e-4 (the CPU tests' bound,
which one TF32 product per matmul would miss 20-30 times over; the kernel's
three-term TF32 split keeps fp32 level), K3's bf16 route atol = rtol = 2**-6
(a few bf16 steps of the output: tests/test_torch_attention.py's BF16_FLASH,
which its model of the kernel's arithmetic meets against the same plain
version), the model 2e-4 x peak — all with TF32 off unless a test sets a
precision policy.
"""

import itertools

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from demucs_tpu_torch.models.htdemucs import precision_scope

    with precision_scope(None):
        yield torch.device("cuda")


def _randn(*shape, seed=0, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(device)


@pytest.mark.parametrize("rows,length,n_fft,hop", [
    (2, 351232, 4096, 1024),  # one 7.8 s segment, stereo
    (12, 351232, 4096, 1024),  # the served batch of 6 segments
    (3, 5000, 2048, 512), (2, 5000, 1024, 256), (2, 3000, 512, 128),
    (1, 1000, 256, 100),  # hop does not divide n_fft
    (3, 4097, 512, 129),  # odd hop and row length: frames start unaligned
    (1, 40000, 16384, 4096)])
def test_stft_kernel_matches_plain(cuda, rows, length, n_fft, hop):
    from demucs_tpu_torch.kernels import stft as K

    x = _randn(rows, length)
    before = K.stft_dft.launches
    got = K.stft_dft(x, n_fft, hop)
    want = K.stft_dft_plain(x, n_fft, hop)
    torch.cuda.synchronize()
    assert K.stft_dft.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


@pytest.mark.parametrize("rows,n_frames,n_fft,hop,edge_imag", [
    (8, 340, 4096, 1024, None),  # one 7.8 s segment, 4 stems x stereo
    (48, 340, 4096, 1024, None),  # the served batch of 6 segments
    (3, 17, 2048, 512, None), (2, 30, 1024, 256, None), (3, 40, 512, 128, None),
    (2, 25, 512, 64, None),  # 8 frames reach each output chunk
    (8, 340, 4096, 1024, 50.0),  # large imaginary DC and Nyquist bins: ignored
    (1, 9, 16384, 4096, None)])
def test_istft_kernel_matches_plain(cuda, rows, n_frames, n_fft, hop, edge_imag):
    from demucs_tpu_torch.kernels import stft as K

    zr = _randn(rows, n_frames, n_fft // 2 + 1, seed=1)
    zi = _randn(rows, n_frames, n_fft // 2 + 1, seed=2)
    if edge_imag is not None:
        zi[..., 0] = zi[..., -1] = edge_imag
    got = K.istft_dft(zr, zi, n_fft, hop)
    want = K.istft_dft_plain(zr, zi, n_fft, hop)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("B,Tq,Tk,C,H", [
    (1, 2688, 2688, 512, 8), (2, 300, 130, 128, 4), (1, 70, 90, 384, 8), (2, 1, 33, 64, 1),
    (6, 2688, 1344, 512, 8), (6, 1344, 2688, 512, 8),  # the served batch, freq<-time, time<-freq
    (1, 1000, 700, 384, 8)])  # Tq not a multiple of the block's 64 or 128 rows, head dim 48
def test_flash_mha_kernel_matches_plain(cuda, B, Tq, Tk, C, H):
    from demucs_tpu_torch.kernels import attention as K

    q, k, v = _randn(B, Tq, C, seed=3), _randn(B, Tk, C, seed=4), _randn(B, Tk, C, seed=5)
    before = K.flash_mha.launches
    got = K.flash_mha(q, k, v, H)
    torch.cuda.synchronize()
    assert K.flash_mha.launches == before + 1
    want = K.flash_mha_plain(q, k, v, H)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("C,H", [(128, 4), (384, 8), (512, 8)])
def test_flash_mha_kernel_block_shapes(cuda, monkeypatch, rows, C, H):
    """Every template instance (head dim x rows per block)."""
    from demucs_tpu_torch.kernels import attention as K

    monkeypatch.setattr(K, "BLOCK_ROWS", rows)
    q, k, v = _randn(2, 333, C, seed=13), _randn(2, 517, C, seed=14), _randn(2, 517, C, seed=15)
    got = K.flash_mha(q, k, v, H)
    want = K.flash_mha_plain(q, k, v, H)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-5, rtol=1e-4)


def test_flash_mha_kernel_unaligned_views(cuda):
    """Inputs that are views one float past a 16-byte boundary (the layout
    pass reads k and v as float4s)."""
    from demucs_tpu_torch.kernels import attention as K

    q, k, v = (_randn(1, 200 * 128 + 1, seed=s)[0, 1:].view(1, 200, 128) for s in (16, 17, 18))
    assert k.data_ptr() % 16 != 0
    got = K.flash_mha(q, k, v, 4)
    want = K.flash_mha_plain(q, k, v, 4)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("T,C,H", [(300, 128, 4), (2688, 512, 8)])
def test_flash_mha_kernel_masks(cuda, T, C, H):
    from demucs_tpu_torch.kernels import attention as K

    # 128 channels in 4 heads: head dim 32, as in the golden config; then the
    # released freq<-freq shape
    q, k, v = (_randn(1, T, C, seed=s) for s in (6, 7, 8))
    mask = torch.rand(T, T, generator=torch.Generator().manual_seed(9)) > 0.7
    mask[:, :64] = False  # the first key tile, fully masked for every row
    mask[11] = False  # a row with no kept key
    before = K.flash_mha.launches
    got = K.flash_mha(q, k, v, H, mask=mask.cuda()).cpu()
    assert K.flash_mha.launches == before + 1
    want = K.flash_mha_plain(q, k, v, H, mask=mask.cuda()).cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and torch.isnan(got[0, 11]).all()
    keep = torch.isfinite(want)
    np.testing.assert_allclose(got[keep].numpy(), want[keep].numpy(), atol=2e-5, rtol=1e-4)


def test_wrappers_raise_instead_of_falling_back(cuda):
    from demucs_tpu_torch.kernels import attention as KA
    from demucs_tpu_torch.kernels import stft as KS

    x = _randn(2, 8192)
    with pytest.raises(TypeError):
        KS.stft_dft(x.double(), 2048, 512)
    with pytest.raises(ValueError):
        KS.stft_dft(_randn(8192, 2).t(), 2048, 512)  # not contiguous
    q = _randn(1, 16, 144)
    with pytest.raises(ValueError, match="head dims"):
        KA.flash_mha(q, q, q, 1)  # head dim 144: no instance (80 runs padded to 128)
    with pytest.raises(ValueError, match="head dims"):  # nor its gradient
        KA.flash_mha(q.clone().requires_grad_(), q, q, 1)
    qb = _randn(1, 16, 64).bfloat16()
    qf = _randn(1, 16, 64)
    with pytest.raises(TypeError):
        KA.flash_mha_bwd_bf16(qf, qf, qf, qf, qf, 1, lse=_randn(1, 16))  # fp32, bf16 route
    # K3's bf16 route drops by the hash and launches its backward kernel
    before = (KA.flash_mha_bf16.launches, KA.flash_mha_bwd_bf16.launches)
    qb.requires_grad_()
    out = KA.flash_mha(qb, qb, qb, 1, dropout=0.1, dropout_seed=1)
    out.float().sum().backward()
    assert (KA.flash_mha_bf16.launches, KA.flash_mha_bwd_bf16.launches) == (
        before[0] + 1, before[1] + 1)
    assert out.dtype == qb.grad.dtype == torch.bfloat16
    # K1, K2 and K3's fp32 route launch their backward kernels
    q = _randn(1, 16, 64).requires_grad_()
    before = KA.flash_mha_bwd.launches
    KA.flash_mha(q, q, q, 1).sum().backward()
    assert KA.flash_mha_bwd.launches == before + 1 and q.grad is not None
    before = KS.stft_dft_backward.launches
    zr, _ = KS.stft_dft(x.requires_grad_(), 2048, 512)
    zr.sum().backward()
    assert KS.stft_dft_backward.launches == before + 1
    zr, zi = _randn(2, 13, 1025, seed=11).requires_grad_(), _randn(2, 13, 1025, seed=12)
    before = KS.istft_dft_backward.launches
    KS.istft_dft(zr, zi, 2048, 512).sum().backward()
    assert KS.istft_dft_backward.launches == before + 1


@pytest.mark.parametrize("n_fft", [1536, 128, 32768])
def test_stft_kernels_raise_for_unsupported_n_fft(cuda, n_fft):
    """Only a power-of-two n_fft from 256 to 16384: nothing falls back."""
    from demucs_tpu_torch.kernels import stft as KS

    before = (KS.stft_dft.launches, KS.istft_dft.launches)
    with pytest.raises(ValueError, match="power-of-two n_fft"):
        KS.stft_dft(_randn(2, 3 * n_fft), n_fft, n_fft // 4)
    z = _randn(2, 5, n_fft // 2 + 1)
    with pytest.raises(ValueError, match="power-of-two n_fft"):
        KS.istft_dft(z, z, n_fft, n_fft // 4)
    assert (KS.stft_dft.launches, KS.istft_dft.launches) == before


def test_card_path_builds_no_dense_basis(cuda):
    from demucs_tpu_torch.kernels import stft as KS
    from demucs_tpu_torch.ops import spec

    KS._stft_basis.cache_clear()
    KS._istft_basis.cache_clear()
    x = _randn(1, 2, 20000)
    y = spec.demucs_ispec(spec.demucs_spec(x, 4096), 20000)
    torch.cuda.synchronize()
    assert y.shape == x.shape
    assert KS._stft_basis.cache_info().currsize == 0
    assert KS._istft_basis.cache_info().currsize == 0


def test_model_card_matches_cpu(cuda):
    import copy

    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs

    cfg = HTDemucsConfig(channels=16, depth=4, nfft=2048, t_layers=3, t_heads=4, segment=0.5,
                         samplerate=8000)
    model = init_htdemucs(cfg, seed=7, layer_scale=1.0, random_norms=True).eval()
    mix = _randn(2, 2, 4000, seed=10, device="cpu") * 0.1
    with torch.inference_mode():
        want = model(mix)
        got = copy.deepcopy(model).to(cuda)(mix.to(cuda)).cpu()
    assert (got - want).abs().max().item() <= 2e-4 * want.abs().max().item()


def _small_model(seed=7):
    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs
    from demucs_tpu_torch.models.registry import Model

    cfg = HTDemucsConfig(channels=16, depth=4, nfft=2048, t_layers=3, t_heads=4, segment=0.5,
                         samplerate=8000)
    module = init_htdemucs(cfg, seed=seed, layer_scale=1.0, random_norms=True).eval()
    return Model("htdemucs", cfg, module.cuda())


@pytest.mark.parametrize("batch", [1, 6])
def test_graph_replay_matches_eager_forward(cuda, batch):
    """The released width at its 7.8 s segment: a replay of the captured forward
    against an eager forward of the same module (1e-6 x peak; the same
    kernels on the same inputs, so bit-equal unless a library picks another
    algorithm under capture)."""
    from demucs_tpu_torch.inference.engine import GraphCache
    from demucs_tpu_torch.kernels import stft as KS
    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs

    cfg = HTDemucsConfig(channels=48, depth=4, nfft=4096, t_layers=5, t_heads=8, dconv_mode=3,
                         bottom_channels=512, segment=7.8)
    module = init_htdemucs(cfg, seed=3, layer_scale=1.0, random_norms=True).eval().to(cuda)
    mix = _randn(batch, 2, cfg.training_length, seed=20) * 0.1
    graphs = GraphCache()
    before = KS.stft_dft.launches
    with torch.inference_mode():
        want = module(mix).clone()
        got = graphs.forward(module, mix).clone()
        again = graphs.forward(module, mix * 0.5).clone()
        half = module(mix * 0.5)
    assert KS.stft_dft.launches == before + 3  # two eager forwards and the warm-up
    assert graphs.captures == 1 and graphs.replays == 2
    launched = {k: n for k, n in graphs.replayed_launches.items() if n}
    assert launched == {"stft_dft": 2, "istft_dft": 2, "flash_mha": 20, "flash_mha D=64": 20}
    peak = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-6 * peak
    assert (again - half).abs().max().item() <= 1e-6 * half.abs().max().item()


def test_graph_recaptured_when_segment_changes(cuda):
    """A new segment changes how far the forward pads its input, at the same
    input shape: the cached graph is captured again, not replayed stale."""
    from demucs_tpu_torch.inference.engine import GraphCache

    model = _small_model()
    mix = _randn(2, 2, 1500, seed=40) * 0.1
    graphs = GraphCache()
    with torch.inference_mode():
        graphs.forward(model.module, mix)
        model.segment = 0.25  # training length 2000 samples instead of 4000
        got = graphs.forward(model.module, mix).clone()
        want = model.module(mix)
    assert graphs.captures == 2 and graphs.replays == 2
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


@pytest.mark.parametrize("overlap,shifts", [(0.25, 2), (0.6, 1)])
def test_device_engine_matches_host_engine_on_card(cuda, overlap, shifts):
    import random

    from demucs_tpu_torch.inference.apply import apply_model

    model = _small_model()
    mix = _randn(1, 2, 9200, seed=21, device="cpu").numpy() * 0.1
    kw = dict(shifts=shifts, overlap=overlap, batch_size=2)
    want = apply_model(model, mix, engine="host", rng=random.Random(4), **kw)
    got = apply_model(model, mix, rng=random.Random(4), **kw)  # "auto" on the card: device
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_pipelined_tracks_equal_single_calls_on_card(cuda):
    import random

    from demucs_tpu_torch.inference import engine

    model = _small_model()
    tracks = [_randn(1, 2, n, seed=30 + n, device="cpu").numpy() * 0.1
              for n in (9200, 4800, 13000)]
    rng = random.Random(8)
    want = [engine.device_apply_model(model, t, batch_size=2, rng=rng) for t in tracks]
    got = list(engine.device_separate_tracks(model, tracks, batch_size=2,
                                             rng=random.Random(8)))
    assert all(torch.equal(torch.from_numpy(g), torch.from_numpy(w)) for g, w in zip(got, want))


def _family_model(kind, seed=7, **kw):
    """The released HDemucs (hdemucs_mmi's shape) or Demucs v2 widths, unit
    LayerScales and random norms, on the CPU."""
    from demucs_tpu_torch.models import demucs as D
    from demucs_tpu_torch.models import hdemucs as H

    if kind == "hdemucs":
        cfg = H.HDemucsConfig(channels=48, depth=6, nfft=4096, segment=44, **kw)
        return H.init_hdemucs(cfg, seed, layer_scale=1.0, random_norms=True).eval()
    cfg = D.DemucsConfig(channels=64, depth=6, segment=44, **kw)
    return D.init_demucs(cfg, seed, layer_scale=1.0, random_norms=True).eval()


@pytest.mark.parametrize("kind,kw", [("hdemucs", {}), ("demucs", {}),
                                     ("hdemucs", dict(hybrid_old=True, cac=False,
                                                      wiener_iters=1))])
def test_hdemucs_and_demucs_card_match_cpu(cuda, kind, kw):
    """A 1.5 s input through the released widths: cuDNN's LSTM and the
    LocalState products with TF32 off, 2e-4 x peak of the CPU forward."""
    import copy

    model = _family_model(kind, **kw)
    mix = _randn(1, 2, 66150, seed=50, device="cpu") * 0.1
    with torch.inference_mode():
        want = model(mix)
        got = copy.deepcopy(model).to(cuda)(mix.to(cuda)).cpu()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 2e-4 * want.abs().max().item()


@pytest.mark.parametrize("kind", ["hdemucs", "demucs"])
def test_lstm_forward_graph_replay_matches_eager(cuda, kind):
    """A CUDA graph captured around cuDNN's LSTM (BLSTM in the DConv branches)
    replays the eager forward at a 10 s segment, batch 2."""
    from demucs_tpu_torch.inference.engine import GraphCache
    from demucs_tpu_torch.models.demucs import valid_length

    module = _family_model(kind, seed=3).to(cuda)
    length = 441000 if kind == "hdemucs" else valid_length(module.cfg, 441000)
    mix = _randn(2, 2, length, seed=51) * 0.1
    graphs = GraphCache()
    with torch.inference_mode():
        want = module(mix).clone()
        got = graphs.forward(module, mix).clone()
    assert graphs.captures == 1 and graphs.replays == 1
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


def test_wiener_and_resampler_card_match_cpu(cuda):
    from demucs_tpu_torch.ops.resample import resample_frac
    from demucs_tpu_torch.ops.wiener import apply_wiener

    g = torch.Generator().manual_seed(52)
    mags = torch.rand(1, 4, 2, 512, 400, generator=g) * 20
    z = torch.complex(torch.randn(1, 2, 512, 400, generator=g),
                      torch.randn(1, 2, 512, 400, generator=g)) * 20
    want = apply_wiener(mags, z, 2)
    got = apply_wiener(mags.to(cuda), z.to(cuda), 2).cpu()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    x = _randn(2, 2, 48000, seed=53, device="cpu")
    for old, new in ((1, 2), (2, 1), (48000, 44100)):
        want = resample_frac(x, old, new)
        got = resample_frac(x.to(cuda), old, new).cpu()
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


# ---- K3's bf16 route ----

BF16_TOL = dict(atol=2 ** -6, rtol=2 ** -6)


def _bf16_close(got, want):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **BF16_TOL)


@pytest.mark.parametrize("keys", [64, 128])
@pytest.mark.parametrize("d", [32, 48, 64])
def test_flash_mha_bf16_tiles(cuda, d, keys):
    """One S tile and one P V tile alone, through the kernel's tensor-map
    copies, swizzled tile image, descriptors and fragment maps: exact
    products of bf16 values, summed in fp32 (1e-5 of the sums' size)."""
    from demucs_tpu_torch.kernels import attention as K

    q = _randn(64, d, seed=60).bfloat16()
    k, v = (_randn(keys, d, seed=s).bfloat16() for s in (61, 62))
    p = torch.rand(64, keys, generator=torch.Generator().manual_seed(63)).to(cuda)
    s_tile, o_tile = K.bf16_tiles(q, k, v, p)
    torch.cuda.synchronize()
    want_s = q.double() @ k.double().T
    want_o = p.bfloat16().double() @ v.double()
    assert (s_tile.double() - want_s).abs().max().item() <= 1e-5 * want_s.abs().max().item()
    assert (o_tile.double() - want_o).abs().max().item() <= 1e-5 * want_o.abs().max().item()


@pytest.mark.parametrize("B,Tq,Tk,C,H", [
    (1, 2688, 2688, 512, 8), (6, 2688, 2688, 512, 8),  # freq<-freq, one segment and the batch
    (1, 1344, 1344, 512, 8), (6, 2688, 1344, 512, 8), (6, 1344, 2688, 512, 8),
    (2, 300, 130, 128, 4), (1, 70, 90, 384, 8), (2, 1, 33, 64, 1),
    (1, 1000, 700, 384, 8),  # Tq not a multiple of the block's rows, head dim 48
    (3, 200, 130, 512, 8)])  # B > 1, Tk not a multiple of the key tile: a box past Tk
def test_flash_mha_bf16_kernel_matches_plain(cuda, monkeypatch, B, Tq, Tk, C, H):
    """bf16 CUDA inputs launch the bf16 kernel and never reach the plain version."""
    from demucs_tpu_torch.kernels import attention as K

    q, k, v = (_randn(B, T, C, seed=s).bfloat16() for s, T in ((64, Tq), (65, Tk), (66, Tk)))
    want = K.flash_mha_plain(q, k, v, H)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(K, "flash_mha_plain", refuse)
    before = (K.flash_mha.launches, K.flash_mha_bf16.launches)
    got = K.flash_mha(q, k, v, H)
    torch.cuda.synchronize()
    assert (K.flash_mha.launches, K.flash_mha_bf16.launches) == (before[0], before[1] + 1)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _bf16_close(got, want)


@pytest.mark.parametrize("B,Tq", [(0, 33), (2, 0)])
def test_flash_mha_bf16_empty_launches_nothing(cuda, B, Tq):
    """An empty batch or query gives an empty bf16 output and launches nothing."""
    from demucs_tpu_torch.kernels import attention as K

    q = _randn(B, Tq, 64).bfloat16()
    k = _randn(B, 33, 64).bfloat16()
    before = K.flash_mha_bf16.launches
    got = K.flash_mha(q, k, k, 1)
    assert got.shape == (B, Tq, 64) and got.dtype == torch.bfloat16
    assert K.flash_mha_bf16.launches == before


def test_flash_mha_bf16_kernel_masks(cuda):
    from demucs_tpu_torch.kernels import attention as K

    T, C, H = 2688, 512, 8
    q, k, v = (_randn(1, T, C, seed=s).bfloat16() for s in (67, 68, 69))
    mask = torch.rand(T, T, generator=torch.Generator().manual_seed(70)) > 0.7
    mask[:, :K.KEY_TILE_BF16] = False  # the first key tile, fully masked for every row
    mask[11] = False  # a row with no kept key
    got = K.flash_mha_bf16(q, k, v, H, mask=mask.cuda()).float().cpu()
    want = K.flash_mha_plain(q, k, v, H, mask=mask.cuda()).float().cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and torch.isnan(got[0, 11]).all()
    keep = torch.isfinite(want)
    np.testing.assert_allclose(got[keep].numpy(), want[keep].numpy(), **BF16_TOL)


@pytest.mark.parametrize("key_tile,rows,persistent", [
    (64, 128, False), (64, 192, False), (128, 128, True), (128, 192, True), (64, 192, True),
    (128, 128, False)])
def test_flash_mha_bf16_plans_match_plain(cuda, monkeypatch, key_tile, rows, persistent):
    """Every plan of the bf16 route (chip_smoke.py sweeps them): keys per tile,
    rows per block, the persistent schedule (row blocks shared by two ranges
    and merged) or a block per row block, on a ragged batch with a mask and a
    fully masked row."""
    from demucs_tpu_torch.kernels import attention as K

    monkeypatch.setattr(K, "KEY_TILE_BF16", key_tile)
    monkeypatch.setattr(K, "BF16_ROWS", rows)
    monkeypatch.setattr(K, "BF16_PERSISTENT", persistent)
    B, Tq, Tk, C, H = 3, 300, 390, 384, 8
    q, k, v = (_randn(B, T, C, seed=s).bfloat16() for s, T in ((72, Tq), (73, Tk), (74, Tk)))
    mask = torch.rand(Tq, Tk, generator=torch.Generator().manual_seed(75)) > 0.5
    mask[:, :key_tile] = False
    mask[5] = False
    got = K.flash_mha_bf16(q, k, v, H, mask=mask.cuda()).float().cpu()
    want = K.flash_mha_plain(q, k, v, H, mask=mask.cuda()).float().cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and torch.isnan(got[:, 5]).all()
    keep = torch.isfinite(want)
    np.testing.assert_allclose(got[keep].numpy(), want[keep].numpy(), **BF16_TOL)


def test_flash_mha_other_dtypes_raise(cuda):
    from demucs_tpu_torch.kernels import attention as K

    q = _randn(1, 16, 64)
    with pytest.raises(TypeError):
        K.flash_mha(q.half(), q.half(), q.half(), 1)
    with pytest.raises(TypeError):
        K.flash_mha_bf16(q, q, q, 1)  # fp32 on the bf16 route
    with pytest.raises(TypeError):
        K.flash_mha(q.bfloat16(), q, q, 1)  # mixed dtypes


@pytest.mark.parametrize("precision,flags", [
    (None, (False, False, False)), ("tensorfloat32", (True, True, False)),
    ("bfloat16", (True, True, True))])
def test_precision_scope_inside_a_captured_graph(cuda, precision, flags):
    """The policy's flags are in force while the forward is captured (a graph
    bakes in the kernels chosen under them), and the replay equals the eager
    forward under the same policy."""
    from demucs_tpu_torch.inference.engine import GraphCache
    from demucs_tpu_torch.models.registry import reconfigured
    from demucs_tpu_torch.ops import nn as ops

    model = reconfigured(_small_model(), matmul_precision=precision)
    seen = []
    model.module.encoder[0].register_forward_pre_hook(lambda *_: seen.append((
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
        ops._BF16_OPERANDS, torch.cuda.is_current_stream_capturing())))
    mix = _randn(2, 2, 4000, seed=71) * 0.1
    graphs = GraphCache()
    with torch.inference_mode():
        got = graphs.forward(model.module, mix).clone()
        want = model.module(mix)
    assert (flags + (True,)) in seen  # the capture
    assert all(s[:3] == flags for s in seen)
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
    assert torch.backends.cuda.matmul.allow_tf32 is False  # restored


def test_fast_policy_on_card(cuda):
    """compute_dtype="bfloat16" on the card: K3's bf16 route in every attention,
    output fp32 and close to the fp32 forward (SER over 20 dB, random weights)."""
    from demucs_tpu_torch.kernels import attention as K
    from demucs_tpu_torch.models.registry import reconfigured

    model = _small_model()
    fast = reconfigured(model, compute_dtype="bfloat16")
    mix = _randn(2, 2, 4000, seed=72) * 0.1
    before = (K.flash_mha.launches, K.flash_mha_bf16.launches)
    with torch.inference_mode():
        want = model.module(mix)
        got = fast.module(mix)
    assert (K.flash_mha.launches - before[0], K.flash_mha_bf16.launches - before[1]) == (6, 6)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    ser = 10 * torch.log10(want.pow(2).sum() / (want - got).pow(2).sum()).item()
    assert ser > 20


def test_fast_preset_is_deterministic_on_card(cuda):
    """C4: the released HTDemucs under the fast preset (bf16 in every core
    stage) gives the same output bit for bit in two eager forwards and in two
    replays of its CUDA graph (the decoders' 16-bit transposed convolutions
    run cuDNN's deterministic algorithms, ``ops/nn.py::_deterministic16``),
    and the setting does not leak out of those calls."""
    from demucs_tpu_torch.inference.engine import GraphCache
    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs
    from demucs_tpu_torch.models.registry import Model, reconfigured

    cfg = HTDemucsConfig(channels=48, depth=4, nfft=4096, t_layers=5, t_heads=8, dconv_mode=3,
                         bottom_channels=512, segment=7.8)
    module = init_htdemucs(cfg, seed=3, layer_scale=1.0, random_norms=True).eval().to(cuda)
    fast = reconfigured(Model("htdemucs", cfg, module), compute_dtype="bfloat16").module
    mix = _randn(2, 2, cfg.training_length, seed=21) * 0.1
    graphs = GraphCache()
    with torch.inference_mode():
        eager = [fast(mix).clone() for _ in range(2)]
        replays = [graphs.forward(fast, mix).clone() for _ in range(2)]
    assert torch.equal(eager[0], eager[1])
    assert torch.equal(replays[0], replays[1])
    assert torch.isfinite(eager[0]).all()
    assert torch.backends.cudnn.deterministic is False


# ---- several cards: the device engine's segment split and bag fan-out ----


@pytest.fixture
def cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_kernel_wrappers_need_the_tensor_device_current(cards):
    """A launch runs on the current device: a wrapper given a tensor of
    another card raises, and under ``torch.cuda.device`` it launches there."""
    from demucs_tpu_torch.kernels import stft as K

    x = _randn(2, 5000, device=cards[1])
    with pytest.raises(RuntimeError, match="current device"):
        K.stft_dft(x, 1024, 256)
    with torch.cuda.device(cards[1]):
        got = K.stft_dft(x, 1024, 256)
        want = K.stft_dft_plain(x, 1024, 256)
    for g, w in zip(got, want):
        assert g.device == cards[1]
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


def test_apply_model_spreads_segments_over_every_card(cards):
    """``apply_model`` on a host of several cards takes every card
    (``auto_devices``): each card replays its own graph, and the stems match
    the one-device engine within 1e-5 x peak (other batch shapes per card)."""
    import random

    from demucs_tpu_torch.inference.apply import apply_model
    from demucs_tpu_torch.inference.engine import GRAPHS, device_apply_model
    from demucs_tpu_torch.parallel.sharded import auto_devices

    model = _small_model()
    assert auto_devices(model.device) == cards
    mix = _randn(1, 2, 8000 * 20, seed=83, device="cpu").numpy() * 0.1
    want = device_apply_model(model, mix, shifts=1, rng=random.Random(3))
    GRAPHS.clear()
    got = apply_model(model, mix, shifts=1, rng=random.Random(3))
    assert {key[2] for key in GRAPHS.entries} == set(cards)
    assert np.isfinite(got).all() and _rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("members,n_cards", [(4, 4), (2, 4), (4, 2)])
def test_bag_over_several_cards_matches_sequential(cards, members, n_cards):
    """A homogeneous bag over ``n_cards`` cards (members dividing the cards
    fan out, each member on its group of cards; else the segments split)
    against the sequential engine on one card, 1e-5 x peak."""
    import random

    from demucs_tpu_torch.inference.engine import device_apply_model
    from demucs_tpu_torch.models.registry import BagOfModels

    if n_cards > len(cards):
        pytest.skip(f"needs {n_cards} cards")
    bag = BagOfModels([_small_model(seed=30 + k) for k in range(members)])
    mix = _randn(1, 2, 8000 * 6, seed=84, device="cpu").numpy() * 0.1
    want = device_apply_model(bag, mix, shifts=1, rng=random.Random(4))
    got = device_apply_model(bag, mix, shifts=1, rng=random.Random(4),
                             devices=cards[:n_cards])
    assert np.isfinite(got).all() and _rel_err(got, want) <= 1e-5


# Least SER of each preset's forward against the fp32 forward on the card, dB
# (chip_smoke.py PRESET_SER_DB: a preset under its bound fails that run too).
PRESET_SER_DB = {"default": 100.0, "quality": 100.0, "balanced": 30.0, "fast": 20.0}


@pytest.mark.parametrize("preset", ["default", "fast", "balanced", "quality"])
def test_presets_ser_on_card(cuda, preset):
    from demucs_tpu_torch.api import _apply_precision
    from demucs_tpu_torch.presets import resolve_preset

    model = _small_model()
    compute_dtype, matmul_precision, _, _ = resolve_preset(preset, None)
    policy = _apply_precision(model, compute_dtype, matmul_precision)
    mix = _randn(2, 2, 4000, seed=73) * 0.1
    with torch.inference_mode():
        want = model.module(mix)
        got = policy.module(mix)
    err = (want - got).pow(2).sum().item()
    assert err == 0 or 10 * np.log10(want.pow(2).sum().item() / err) >= PRESET_SER_DB[preset]


def test_stream_graph_replays_match_eager_on_card(cuda, monkeypatch):
    """StreamSeparator on the card: its full segments replay one CUDA graph,
    against the same stream with every segment eager (1e-6 x peak) and against
    apply_model(shifts=0) (1e-5 x peak: other batches, other cuDNN choices)."""
    from demucs_tpu_torch.inference import streaming
    from demucs_tpu_torch.inference.apply import apply_model
    from demucs_tpu_torch.inference.engine import GRAPHS

    model = _small_model()
    mix = _randn(1, 2, 13200, seed=80, device="cpu").numpy() * 0.1
    sizes = [3000, 777, 5000, 1234, 3189]

    def run():
        stream = streaming.StreamSeparator(model)
        parts, pos = [], 0
        for n in sizes:
            parts.append(stream.feed(mix[0, :, pos:pos + n]))
            pos += n
        parts.append(stream.flush())
        return np.concatenate(parts, axis=-1)[None], stream

    replays = GRAPHS.replays
    got, stream = run()
    assert GRAPHS.replays - replays == stream.graph_segments > 0 and stream.eager_segments > 0
    monkeypatch.setattr(streaming, "_forward", lambda module, batch: module(batch))
    eager, _ = run()
    peak = np.abs(eager).max()
    assert np.abs(got - eager).max() <= 1e-6 * peak
    want = apply_model(model, mix, shifts=0)
    assert np.abs(got - want).max() <= 1e-5 * peak


def test_served_request_equals_separate_tensor_on_card(cuda, tmp_path):
    """A float32 WAV request through SeparationService on the card gives the
    stems of Separator.separate_tensor on the decoded body, bit for bit."""
    import io
    import zipfile

    from demucs_tpu_torch import audio
    from demucs_tpu_torch.serve import SeparationService
    from demucs_tpu_torch.zoo.native import save_model

    model = _small_model()
    save_model(model, tmp_path / "small.dmx", half=False)
    service = SeparationService(model="small", repo=tmp_path, device="cuda", shifts=0)
    wav = _randn(2, 11000, seed=81, device="cpu").numpy() * 0.1
    audio.save_audio(wav, tmp_path / "in.wav", 8000, as_float=True, clip="none")
    blob = service.separate_bytes((tmp_path / "in.wav").read_bytes(), float32=True,
                                  clip="none")
    decoded, _ = audio.read_audio(tmp_path / "in.wav", samplerate=8000, channels=2)
    _, want = service.separator.separate_tensor(decoded)
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        for name, stem in want.items():
            (tmp_path / f"{name}.wav").write_bytes(zf.read(f"{name}.wav"))
            got, _ = audio.read_audio(tmp_path / f"{name}.wav")
            assert np.array_equal(got, stem), name


# ---- K3 under HTDemucs's static sparse masks; the variants and the memory report ----

SPARSE_MASKS = ("diag", "global", "jmask", "random", "diag_jmask_random")
# Beside the static masks: "holes", kept at random but for a fully masked row
# block of every plan (rows 0-383), a fully masked key tile of every plan
# (keys 128-255) and one fully masked row; "bare", diag_jmask_random as a
# boolean tensor that did not come from keep_mask (its tile maps are built at
# the first call).
MASK_CASES = SPARSE_MASKS + ("holes", "bare")
TOKEN_SHAPES = ((2688, 2688), (1344, 1344), (2688, 1344), (1344, 2688))  # (Tq, Tk)


def _mask_case(mask_type, Tq, Tk):
    from demucs_tpu_torch.ops.sparse import get_mask, keep_mask

    if mask_type == "holes":
        mask = _randn(Tq, Tk, seed=93) > -0.5
        mask[:384] = False
        mask[:, 128:256] = False
        mask[500] = False
        return mask
    if mask_type == "bare":
        return torch.from_numpy(get_mask(Tk, Tq, "diag_jmask_random", 500, 100, 42,
                                         0.95)).cuda()
    return keep_mask(Tq, Tk, mask_type, 500, 100, 42, 0.95, "cuda")


def _sparse_case(mask_type, Tq, Tk, bf16, B=2):
    """Released q, k, v widths (512 channels, 8 heads) and the keep-mask of
    ``mask_type`` (MASK_CASES; the static ones cached at the reference's
    defaults: window 500, global 100, sparsity 0.95)."""
    q, k, v = (_randn(B, T, 512, seed=s) for s, T in ((90, Tq), (91, Tk), (92, Tk)))
    if bf16:
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    return q, k, v, _mask_case(mask_type, Tq, Tk)


def _masked_close(got, want, tol):
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))  # NaN only where the plain has it
    keep = torch.isfinite(want)
    np.testing.assert_allclose(got[keep].numpy(), want[keep].numpy(), **tol)


@pytest.mark.parametrize("Tq,Tk", TOKEN_SHAPES)
@pytest.mark.parametrize("mask_type", MASK_CASES)
def test_flash_mha_kernel_sparse_masks(cuda, monkeypatch, mask_type, Tq, Tk):
    """K3's fp32 route under each static mask at the four released shapes, and
    under a mask with a fully masked row block and key tile and one that
    did not come from keep_mask, at 64 and 128 rows a block."""
    from demucs_tpu_torch.kernels import attention as K

    q, k, v, mask = _sparse_case(mask_type, Tq, Tk, bf16=False)
    want = K.flash_mha_plain(q, k, v, 8, mask=mask)
    for rows in (64, 128):
        monkeypatch.setattr(K, "BLOCK_ROWS", rows)
        before = K.flash_mha.launches
        got = K.flash_mha(q, k, v, 8, mask=mask)
        assert K.flash_mha.launches == before + 1
        _masked_close(got, want, dict(atol=2e-5, rtol=1e-4))


@pytest.mark.parametrize("Tq,Tk", TOKEN_SHAPES)
@pytest.mark.parametrize("mask_type", MASK_CASES)
def test_flash_mha_bf16_sparse_masks(cuda, monkeypatch, mask_type, Tq, Tk):
    """K3's bf16 route under each static mask at the four released shapes, on
    every plan: 64 or 128 keys a tile, 128 or 192 rows, the persistent
    schedule (pieces of a row, some fully masked for a row that keeps keys in
    another, merged) or a block per row block."""
    from demucs_tpu_torch.kernels import attention as K

    q, k, v, mask = _sparse_case(mask_type, Tq, Tk, bf16=True)
    want = K.flash_mha_plain(q, k, v, 8, mask=mask)
    for key_tile, rows, persistent in itertools.product((64, 128), (128, 192), (True, False)):
        monkeypatch.setattr(K, "KEY_TILE_BF16", key_tile)
        monkeypatch.setattr(K, "BF16_ROWS", rows)
        monkeypatch.setattr(K, "BF16_PERSISTENT", persistent)
        _masked_close(K.flash_mha(q, k, v, 8, mask=mask), want, BF16_TOL)


@pytest.mark.parametrize("variant", [
    dict(t_sparse_self_attn=True, t_sparse_cross_attn=True, t_mask_type="diag_jmask_random",
         t_sparse_attn_window=8, t_global_window=4),
    dict(t_sparse_self_attn=True, t_sparse_cross_attn=True, t_auto_sparsity=True),
    dict(t_emb="cape"), dict(cac=False, wiener_iters=1), dict(multi_freqs=(0.25, 0.5))])
def test_variants_card_match_cpu(cuda, variant):
    """Each HTDemucs option on the card against the same weights on the CPU
    (2e-4 x peak; the LSH masks hash the same projections on both)."""
    import copy

    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs

    cfg = HTDemucsConfig(channels=16, depth=4, nfft=2048, t_layers=3, t_heads=4, segment=0.5,
                         samplerate=8000, **variant)
    model = init_htdemucs(cfg, seed=7, layer_scale=1.0, random_norms=True).eval()
    mix = _randn(2, 2, 4000, seed=10, device="cpu") * 0.1
    with torch.inference_mode():
        want = model(mix)
        got = copy.deepcopy(model).to(cuda)(mix.to(cuda)).cpu()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 2e-4 * want.abs().max().item()


def test_sparse_graph_replay_matches_eager(cuda):
    """A static-sparse model captures into a graph (its masks are cached
    tables, built by the warm-up forward) and replays as its eager forward."""
    from demucs_tpu_torch.inference.engine import GraphCache
    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs

    cfg = HTDemucsConfig(channels=16, depth=4, nfft=2048, t_layers=3, t_heads=4, segment=0.5,
                         samplerate=8000, t_sparse_self_attn=True, t_sparse_cross_attn=True,
                         t_sparse_attn_window=8)
    module = init_htdemucs(cfg, seed=7, layer_scale=1.0, random_norms=True).eval().to(cuda)
    mix = _randn(2, 2, 4000, seed=11) * 0.1
    graphs = GraphCache()
    with torch.inference_mode():
        want = module(mix).clone()
        got = graphs.forward(module, mix).clone()
    assert graphs.replayed_launches["flash_mha"] == 6
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


def test_pass_memory_analysis_and_pool_release(cuda):
    """pass_memory_analysis on the card: every key, a peak at least the
    arguments and the stems, the caller's graphs untouched; then clear()
    gives the graphs' pool back to the card through empty_cache()."""
    from demucs_tpu_torch.inference import engine

    model = _small_model()
    graphs = engine.GRAPHS
    mem = engine.pass_memory_analysis(model, 20000)
    assert engine.GRAPHS is graphs
    assert set(mem) == {"argument_gb", "output_gb", "temp_gb", "alias_gb", "peak_estimate_gb",
                        "generated_code_mb"}
    assert mem["peak_estimate_gb"] >= mem["argument_gb"] + mem["output_gb"] > 0
    assert mem["alias_gb"] == 0 and mem["generated_code_mb"] > 0
    engine.device_apply_model(model, _randn(1, 2, 20000, device="cpu").numpy() * 0.1)
    held = graphs.pool_bytes()
    assert held > 0
    reserved = torch.cuda.memory_reserved()
    graphs.clear()
    torch.cuda.empty_cache()
    assert graphs.pool_bytes() == 0 and torch.cuda.memory_reserved() <= reserved - held


# ---- training: K3's dropout and backward kernel, K1/K2's backward, a train step ----
# Gradients 1e-4 x each gradient's peak against the plain backward formula
# (fp32 sums of up to 2688 terms with the cancellation of dS = P (dP - D));
# the train step's loss, reco and global norm 2e-4 x peak against the CPU (the
# model's bound); every gradient 2e-4 x its own peak plus 1e-5 x the largest
# gradient's peak (a bias before a norm has a zero true gradient), on the mse
# loss: l1's gradient is the sign of each residual, and a residual within the
# devices' fp32 differences of zero flips sign between them (C2 in ROADMAP.md;
# chip_smoke.py's train_c2_probe reads those flips against a float64 step).
# bf16 steps: the gradients as the CPU anchor's bound (tests/test_torch_train.py),
# the CPU's own bf16 step standing for JAX's.


# Besides the first cases, the backward's edges: fewer keys than a block (64)
# and a ragged query tile (32 on the fp32 route, 64 on the bf16 one), at head
# dims 32, 48 and 64; a key count that is not a whole number of 128-key blocks.
BWD_EDGES = [(1, 100, 40, 64, 2, 0.1, True), (2, 77, 33, 96, 2, 0.0, False),
             (1, 129, 50, 128, 2, 0.2, False), (2, 95, 300, 128, 2, 0.1, True)]
# the D = 128 instances (csrc/flash_mha_bwd_d128.cu), with their edges, and a head of 96
# channels padded to them; a released width in 4 heads at freq self
BWD_D128 = [(1, 130, 200, 256, 2, 0.1, False), (2, 333, 190, 512, 4, 0.0, True),
            (2, 333, 190, 512, 4, 0.3, True), (1, 100, 40, 256, 2, 0.1, True),
            (2, 95, 300, 192, 2, 0.1, False), (2, 77, 33, 192, 2, 0.0, True),
            (1, 2688, 2688, 512, 4, 0.1, False)]


@pytest.mark.parametrize("B,Tq,Tk,C,H,rate,masked", [
    (1, 64, 64, 64, 1, 0.0, False), (2, 70, 90, 96, 2, 0.1, True),
    (1, 130, 200, 128, 4, 0.1, False), (1, 300, 257, 256, 8, 0.0, True),
    (2, 333, 190, 512, 8, 0.3, True), *BWD_EDGES, *BWD_D128])
def test_flash_mha_backward_kernel_matches_plain(cuda, B, Tq, Tk, C, H, rate, masked):
    from demucs_tpu_torch.kernels import attention as K

    q, k, v, do = (_randn(B, T, C, seed=s) for s, T in enumerate((Tq, Tk, Tk, Tq)))
    mask = (_randn(Tq, Tk, seed=9) > -0.5) if masked else None
    want_o = K.flash_mha_plain(q, k, v, H, mask=mask, dropout=rate, dropout_seed=77)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = K.flash_mha_bwd.launches
    out = K.flash_mha(*leaves, H, mask=mask, dropout=rate, dropout_seed=77)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert K.flash_mha_bwd.launches == before + 1
    torch.testing.assert_close(out.detach(), want_o, atol=2e-5, rtol=1e-4)
    want = K.flash_mha_bwd_plain(q, k, v, want_o, do, H, mask=mask, dropout=rate,
                                 dropout_seed=77)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


@pytest.mark.parametrize("B,Tq,Tk,C,H,rate,masked", [
    (1, 64, 64, 64, 1, 0.1, False), (2, 70, 90, 96, 2, 0.1, True),
    (1, 130, 200, 128, 4, 0.1, False), (3, 200, 130, 512, 8, 0.3, True),
    (1, 2688, 2688, 512, 8, 0.1, False), (8, 1344, 2688, 512, 8, 0.1, True),
    (2, 1344, 2688, 512, 8, 0.1, "diag"), (1, 2688, 1344, 512, 8, 0.1, "global"),
    # the D = 128 dropout instances, masked or not, and a head of 96 padded to them
    (3, 200, 130, 512, 4, 0.3, True), (1, 2688, 2688, 512, 4, 0.1, False),
    (2, 1344, 2688, 512, 4, 0.1, "diag"), (2, 70, 90, 192, 2, 0.1, True)])
def test_flash_mha_bf16_dropout_matches_plain(cuda, monkeypatch, B, Tq, Tk, C, H, rate, masked):
    """K3's bf16 route with the hashed dropout against the plain version on the
    same bf16 inputs (the bf16 route's tolerance), on every plan (keys per
    tile, rows per block, the persistent schedule or a block per row block,
    forced), each also with its drop pattern read out bit for bit against
    dropout_keep (_bf16_dropped_scores). ``masked``: a random mask (every
    tile partial), or a static mask of MASK_CASES (empty, full and partial
    tiles; no fully masked row, whose NaN the readout cannot take)."""
    from demucs_tpu_torch.kernels import attention as K
    from demucs_tpu_torch.ops.attention import dropout_keep

    q, k, v = (_randn(B, T, C, seed=s).bfloat16() for s, T in enumerate((Tq, Tk, Tk)))
    mask = ((_randn(Tq, Tk, seed=9) > -0.5) if masked is True
            else _mask_case(masked, Tq, Tk) if masked else None)
    want = K.flash_mha_plain(q, k, v, H, mask=mask, dropout=rate, dropout_seed=4242)
    keep = dropout_keep(B * H, Tq, Tk, rate, 4242, q.device).view(B, H, Tq, Tk)
    if mask is not None:
        keep &= mask.bool()
    for keys, rows, persistent in BF16_PLANS:
        monkeypatch.setattr(K, "KEY_TILE_BF16", keys)
        monkeypatch.setattr(K, "BF16_ROWS", rows)
        monkeypatch.setattr(K, "BF16_PERSISTENT", persistent)
        got = K.flash_mha(q, k, v, H, mask=mask, dropout=rate, dropout_seed=4242)
        torch.testing.assert_close(got.float(), want.float(), atol=2 ** -6, rtol=2 ** -6)
        dropped = _bf16_dropped_scores(q, k, H, rate, 4242, mask)
        for start, window in dropped.items():
            assert torch.equal(window, ~keep[..., start:start + window.shape[-1]]), \
                (keys, rows, persistent, start)
    undropped = K.flash_mha(q, k, v, H, mask=mask)
    assert (got.float() - undropped.float()).abs().max() > 0.01


BF16_PLANS = [(keys, rows, persistent) for keys in (64, 128) for rows in (128, 192)
              for persistent in (False, True)]


def _bf16_dropped_scores(q, k, num_heads, rate, seed, mask):
    """The scores K3's bf16 route drops (or masks), read out through one-hot
    values: key j of a window of d keys writes channel j of its head alone, so
    the output there is Z P / l, zero exactly where a score was dropped or
    masked. q and k scaled by 0.3, so that no kept probability underflows.
    Returns {first key of the window: (B, H, Tq, window) bool}, for windows at
    the first, the middle and the last keys."""
    from demucs_tpu_torch.kernels import attention as K

    B, Tq, C = q.shape
    Tk, d = k.shape[1], C // num_heads
    n = min(d, Tk)
    qs, ks = (0.3 * q.float()).bfloat16(), (0.3 * k.float()).bfloat16()
    idx = torch.arange(n, device=q.device)
    out = {}
    for start in sorted({0, (Tk - n) // 2, Tk - n}):
        v = torch.zeros(B, Tk, C, device=q.device, dtype=torch.bfloat16)
        for h in range(num_heads):
            v[:, start + idx, h * d + idx] = 1
        got = K.flash_mha(qs, ks, v, num_heads, mask=mask, dropout=rate, dropout_seed=seed)
        out[start] = (got.view(B, Tq, num_heads, d)[..., :n] == 0).permute(0, 2, 1, 3)
    return out


@pytest.mark.parametrize("B,Tq,Tk,C,H,rate,masked", [
    (1, 64, 64, 64, 1, 0.0, False), (2, 70, 90, 96, 2, 0.1, True),
    (1, 130, 200, 128, 4, 0.1, False), (1, 300, 257, 256, 8, 0.0, True),
    (2, 333, 190, 512, 8, 0.3, True), (1, 2688, 1344, 512, 8, 0.1, False), *BWD_EDGES,
    (8, 2688, 2688, 512, 8, 0.1, False),  # the released freq self at the training batch
    *BWD_D128, (8, 2688, 2688, 512, 4, 0.1, False)])
def test_flash_mha_bf16_backward_kernel_matches_plain(cuda, B, Tq, Tk, C, H, rate, masked):
    """The bf16 backward kernel through autograd against the plain formula:
    each gradient within 2**-6 of its peak (bf16 outputs, Z P and dS rounded
    to bf16 for their products, as tests/test_torch_attention_train.py's
    model of the kernel's arithmetic does)."""
    from demucs_tpu_torch.kernels import attention as K

    q, k, v, do = (_randn(B, T, C, seed=s).bfloat16() for s, T in enumerate((Tq, Tk, Tk, Tq)))
    mask = (_randn(Tq, Tk, seed=9) > -0.5) if masked else None
    want_o = K.flash_mha_plain(q, k, v, H, mask=mask, dropout=rate, dropout_seed=77)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = K.flash_mha_bwd_bf16.launches
    out = K.flash_mha(*leaves, H, mask=mask, dropout=rate, dropout_seed=77)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert K.flash_mha_bwd_bf16.launches == before + 1
    torch.testing.assert_close(out.detach().float(), want_o.float(), atol=2 ** -6, rtol=2 ** -6)
    want = K.flash_mha_bwd_plain(q, k, v, want_o, do, H, mask=mask, dropout=rate,
                                 dropout_seed=77)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert (g.float() - w.float()).abs().max() <= 2 ** -6 * w.float().abs().max()


@pytest.fixture
def deterministic(monkeypatch):
    """``torch.use_deterministic_algorithms(True)`` for one test (cuBLAS asks
    for a fixed workspace under it), restored after."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


# (B, Tq, Tk, H) of test_flash_mha_backward_launches_agree: a small ragged case; the
# deterministic order at the released freq self (2688 tokens, 8 heads) at B = 1 and at the
# training batch 8; a ragged Tq; a Tk whose key blocks exceed the blocks the card holds at
# once (132 of 128 keys or of fp32's 64, 264 of 64 bf16 keys): the plain key-block order
AGREE_SHAPES = {"small": (2, 700, 1500, 4), "freq self B=1": (1, 2688, 2688, 8),
                "freq self B=8": (8, 2688, 2688, 8), "ragged Tq": (2, 1001, 1344, 8),
                "Tk past capacity": (1, 150, 17000, 2)}


@pytest.mark.parametrize("dtype,keys,d,ordered,shape", [
    (torch.float32, None, 64, False, "small"), (torch.bfloat16, 128, 64, False, "small"),
    (torch.bfloat16, 64, 64, False, "small")] + [
    (dtype, keys, d, True, shape) for dtype, keys in ((torch.float32, None), (torch.bfloat16, 64),
                                                      (torch.bfloat16, 128))
    for d in (32, 48, 64) for shape in AGREE_SHAPES] + [
    # D = 128: the bf16 route's one plan (64 keys), the fp32 route's dQ kernel (no atomics)
    (dtype, None, 128, ordered, shape) for dtype in (torch.float32, torch.bfloat16)
    for ordered in (False, True) for shape in AGREE_SHAPES if shape != "freq self B=8"])
def test_flash_mha_backward_launches_agree(cuda, monkeypatch, request, dtype, keys, d, ordered,
                                           shape):
    """By default the blocks of keys add their parts of dQ with atomics, in
    the order they finish, so two launches on the same inputs may differ in
    dQ: within a few fp32 roundings of the sums (1e-5 of dQ's peak) on the
    fp32 route, one bf16 step of dQ's peak (2**-8) on the bf16 route (the
    fp32 sums round to bf16 on either side of a step). dK and dV take no
    atomics: equal. Under torch.use_deterministic_algorithms the blocks add
    in an order fixed by the shape (staggered, or key-block order past the card's
    resident blocks): dQ, dK and dV equal, every head dim and keys plan and
    shape, and each launch within the kernel's tolerance of the plain
    formula (1e-4 x each gradient's peak in fp32, 2**-6 in bf16)."""
    from demucs_tpu_torch.kernels import attention as K

    if ordered:
        request.getfixturevalue("deterministic")
    monkeypatch.setattr(K, "BWD_KEYS_BF16", keys)
    B, Tq, Tk, H = AGREE_SHAPES[shape]
    C = H * d
    q, k, v, do = (_randn(B, T, C, seed=s).to(dtype) for s, T in enumerate((Tq, Tk, Tk, Tq)))
    forward = K._forward_bf16 if dtype == torch.bfloat16 else K._forward_f32
    o, lse = forward(q, k, v, H, None, 0.1, 5, True)
    backward = K.flash_mha_bwd_bf16 if dtype == torch.bfloat16 else K.flash_mha_bwd
    first, second = (backward(q, k, v, o, do, H, lse=lse, dropout=0.1, dropout_seed=5)
                     for _ in range(2))
    torch.cuda.synchronize()
    dq1, dq2 = first[0].float(), second[0].float()
    if ordered or (d == 128 and dtype == torch.float32):  # (that one's dQ takes no atomics)
        assert torch.equal(first[0], second[0])
    if ordered and not (d == 128 and dtype == torch.float32):
        # the order the launch took, as it reports it, and the CPU twin's choice
        plan = K.bwd_plan(dtype, keys or 64, B, Tq, Tk, H, d)
        assert plan["twin_agrees"] and plan["stagger"] is (shape != "Tk past capacity")
    if ordered:
        want = K.flash_mha_bwd_plain(q, k, v, o, do, H, dropout=0.1, dropout_seed=5)
        tol = 2 ** -6 if dtype == torch.bfloat16 else 1e-4
        for g, w in zip(first, want):
            assert (g.float() - w.float()).abs().max() <= tol * w.float().abs().max()
    else:
        bound = 2 ** -8 if dtype == torch.bfloat16 else 1e-5
        assert (dq1 - dq2).abs().max() <= bound * dq1.abs().max()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])


@pytest.mark.parametrize("n_fft,hop,frames,extra", [(4096, 1024, 340, 0), (512, 128, 30, 77)])
def test_stft_backward_kernels_match_plain(cuda, n_fft, hop, frames, extra):
    from demucs_tpu_torch.kernels import stft as KS

    zr = _randn(4, frames, n_fft // 2 + 1, seed=1).requires_grad_()
    zi = _randn(4, frames, n_fft // 2 + 1, seed=2).requires_grad_()
    y = KS.istft_dft(zr, zi, n_fft, hop)
    g = _randn(*y.shape, seed=3)
    got = torch.autograd.grad(y, (zr, zi), g)
    want = KS.istft_dft_backward(g.cpu(), n_fft, hop)
    for a, b in zip(got, want):
        assert (a.cpu() - b).abs().max() <= 1e-4 * b.abs().max()
    x = _randn(3, (frames - 1) * hop + n_fft + extra, seed=4).requires_grad_()
    zr, zi = KS.stft_dft(x, n_fft, hop)
    gr, gi = _randn(*zr.shape, seed=5), _randn(*zr.shape, seed=6)
    (got,) = torch.autograd.grad((zr * gr).sum() + (zi * gi).sum(), x)
    want = KS.stft_dft_backward(gr.cpu(), gi.cpu(), n_fft, hop, x.shape[-1])
    assert (got.cpu() - want).abs().max() <= 1e-4 * want.abs().max()


def test_released_train_step_repeats_under_deterministic_mode(cuda, deterministic):
    """C5: the released HTDemucs's train step (fp32, Adam at lr 1e-4, two
    steps from the same weights and batch) run twice under
    torch.use_deterministic_algorithms gives bit-equal weights: K3's backward
    sums dQ in key-block order, cuDNN takes its deterministic algorithms."""
    import copy

    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs
    from demucs_tpu_torch.models.registry import Model
    from demucs_tpu_torch.train.config import TrainArgs
    from demucs_tpu_torch.train.step import make_optimizer, train_step

    cfg = HTDemucsConfig(channels=48, depth=4, nfft=4096, t_layers=5, t_heads=8, dconv_mode=3,
                         bottom_channels=512, segment=7.8)
    module = init_htdemucs(cfg, seed=3, layer_scale=1.0, random_norms=True,
                           fp32_masters=True).train()
    sources = _randn(2, 4, 2, cfg.training_length, seed=8, device="cpu") * 0.2
    weights = []
    for _ in range(2):
        model = Model("htdemucs", cfg, copy.deepcopy(module).to("cuda"))
        args = TrainArgs()
        args.optim.lr = 1e-4
        optimizer = make_optimizer(args, model)
        for _ in range(2):
            train_step(model, optimizer, sources.to("cuda"), loss="mse")
        weights.append({n: p.detach().cpu() for n, p in model.module.named_parameters()})
        del model, optimizer
    assert all(torch.equal(weights[0][n], weights[1][n]) for n in weights[0])


def test_train_step_card_matches_cpu(cuda):
    import copy

    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs
    from demucs_tpu_torch.models.registry import Model
    from demucs_tpu_torch.train.config import TrainArgs
    from demucs_tpu_torch.train.step import make_optimizer, train_step

    # the transformer at width 64, two heads of 32: a head dim K3 takes
    cfg = HTDemucsConfig(channels=16, depth=3, nfft=1024, t_layers=2, t_heads=2, segment=1.0,
                         samplerate=8000)
    module = init_htdemucs(cfg, seed=2, layer_scale=1.0, random_norms=True).train()
    sources = _randn(2, 4, 2, cfg.training_length, seed=8, device="cpu") * 0.2
    out = {}
    for dev in ("cpu", "cuda"):
        model = Model("htdemucs", cfg, copy.deepcopy(module).to(dev))
        args = TrainArgs()
        args.optim.lr = 0.0
        m = train_step(model, make_optimizer(args, model), sources.to(dev), loss="mse")
        out[dev] = (m, {n: p.grad.cpu() for n, p in model.module.named_parameters()})
    (mc, gc), (mg, gg) = out["cpu"], out["cuda"]
    for key in ("loss", "reco", "grad_norm"):
        assert (mg[key].cpu() - mc[key]).abs().max() <= 2e-4 * mc[key].abs().max()
    peak = max(g.abs().max() for g in gc.values())
    for n, g in gc.items():
        assert (gg[n] - g).abs().max() <= 2e-4 * g.abs().max() + 1e-5 * peak, n


def test_bf16_train_step_card_matches_cpu(cuda):
    """One bf16 mixed-precision step (fp32 masters) on the card and on the CPU:
    the CPU anchor's bound (tests/test_torch_train.py), the CPU's bf16 step
    in JAX's place, on the mse loss (see above): loss and reco 1e-3, the
    global norm 1e-2 (relative),
    each gradient within twice the CPU's own bf16-vs-fp32 gap plus 2e-3 x
    the largest gradient's peak. Parameters, gradients, Adam state: fp32."""
    import copy
    import dataclasses

    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs
    from demucs_tpu_torch.models.registry import Model
    from demucs_tpu_torch.train.config import TrainArgs
    from demucs_tpu_torch.train.step import make_optimizer, train_step

    cfg = HTDemucsConfig(channels=16, depth=3, nfft=1024, t_layers=2, t_heads=2, segment=1.0,
                         samplerate=8000)
    module = init_htdemucs(cfg, seed=2, layer_scale=1.0, random_norms=True).train()
    sources = _randn(2, 4, 2, cfg.training_length, seed=8, device="cpu") * 0.2
    out = {}
    for dev, dtype in (("cpu", "float32"), ("cpu", "bfloat16"), ("cuda", "bfloat16")):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        m = copy.deepcopy(module).to(dev)
        m.cfg = c
        model = Model("htdemucs", c, m)
        args = TrainArgs()
        args.optim.lr = 0.0
        opt = make_optimizer(args, model)
        metrics = train_step(model, opt, sources.to(dev), loss="mse")
        out[dev, dtype] = (metrics, {n: p.grad.cpu() for n, p in m.named_parameters()})
        assert all(p.dtype == p.grad.dtype == torch.float32 for p in m.parameters())
        assert all(t.dtype == torch.float32 for st in opt.state.values() for t in st.values()
                   if t.dim() > 0)
    (m32, g32), (mc, gc), (mg, gg) = (out["cpu", "float32"], out["cpu", "bfloat16"],
                                      out["cuda", "bfloat16"])
    for key, tol in (("loss", 1e-3), ("reco", 1e-3), ("grad_norm", 1e-2)):
        assert (mg[key].cpu() - mc[key]).abs().max() <= tol * mc[key].abs().max()
    peak = max(g.abs().max() for g in gc.values())
    for n, g in gc.items():
        assert (gg[n] - g).abs().max() <= 2 * (g - g32[n]).abs().max() + 2e-3 * peak, n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_mha_op_opcheck(cuda, dtype, masked):
    """The registered op ``demucs_tpu_torch::flash_mha`` on CUDA tensors:
    torch.library.opcheck (schema, fake kernel, dispatch), and one call is
    one launch of the dtype's route, the kernel's own output."""
    from demucs_tpu_torch.kernels import attention as K

    q, k, v = (_randn(2, n, 256, seed=s).to(dtype) for s, n in ((1, 300), (2, 180), (3, 180)))
    mask = (_randn(300, 180, seed=4) > -1.0) if masked else None
    torch.library.opcheck(torch.ops.demucs_tpu_torch.flash_mha.default, (q, k, v, 8, mask))
    counter = K.flash_mha_bf16 if dtype == torch.bfloat16 else K.flash_mha
    before = counter.launches
    got = torch.ops.demucs_tpu_torch.flash_mha(q, k, v, 8, mask)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = K.flash_mha_plain(q, k, v, 8, mask=mask).float()
    atol = 2.0 ** -6 if dtype == torch.bfloat16 else 2e-5
    assert ((got.float() - want).abs() <= atol + atol * want.abs()).all()


def test_exported_core_on_card(cuda, tmp_path):
    """The core exported on the card and on the CPU (moved to the card): the
    same op list, K3 as 2 x t_layers op nodes, the artifact equal to the
    eager core (1e-6 x peak), and the runtime launching K1 and K2 once and
    K3 2 x t_layers times a segment."""
    import copy
    import collections

    from demucs_tpu_torch.export import core as C
    from demucs_tpu_torch.export.run import separate_with_core
    from demucs_tpu_torch.kernels import attention as KA, stft as KS
    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs
    from demucs_tpu_torch.ops.spec import cac_pack, demucs_spec

    cfg = HTDemucsConfig(channels=16, depth=4, nfft=2048, t_layers=3, t_heads=4, segment=0.5,
                         samplerate=8000)
    model = init_htdemucs(cfg, seed=7, layer_scale=1.0, random_norms=True).eval()
    card = copy.deepcopy(model).to(cuda)

    def ops(program):
        return collections.Counter(str(n.target) for n in program.graph.nodes
                                   if n.op == "call_function")

    C.save_core(C.export_program(card), cfg, tmp_path / "card.pt2")
    C.save_core(C.export_program(model), cfg, tmp_path / "cpu.pt2")
    cores = [C.load_core(tmp_path / name, "cuda") for name in ("card.pt2", "cpu.pt2")]
    assert ops(cores[0].program) == ops(cores[1].program)
    assert ops(cores[0].program)["demucs_tpu_torch.flash_mha.default"] == 6
    mix = _randn(1, 2, 4000, seed=12) * 0.1
    mag = cac_pack(demucs_spec(mix, cfg.nfft))
    with torch.inference_mode():
        want = card.forward_core(mag, mix)
    for core in cores:
        for g, w in zip(core(mag, mix), want):
            assert (g - w).abs().max().item() <= 1e-6 * w.abs().max().item()
    track = (_randn(1, 2, 10000, seed=13, device="cpu") * 0.1).numpy()
    counters = (KS.stft_dft, KS.istft_dft, KA.flash_mha, KA.flash_mha_bf16)
    before = [c.launches for c in counters]
    stems = separate_with_core(cores[0], cfg, track)
    segments = 4  # offsets 0, 3000, 6000, 9000
    assert [c.launches - b for c, b in zip(counters, before)] == [segments, segments,
                                                                  6 * segments, 0]
    assert stems.shape == (1, 4, 2, 10000) and np.isfinite(stems).all()


# ---- K3's backward under the static masks: the masked instances ----

# the released shapes and a ragged Tq and Tk (no whole key block or query tile at the end)
MASKED_BWD_SHAPES = TOKEN_SHAPES + ((1001, 1337),)
MASKED_BWD_ROUTES = ((torch.float32, None), (torch.bfloat16, 64), (torch.bfloat16, 128))


def _masked_bwd_case(mask_type, Tq, Tk, dtype, rate, B=1, H=8):
    """Released widths (512 channels, H heads: 8, or 4 of 128 channels), the mask of MASK_CASES, the
    forward's o and lse (the masked forward of the dtype's route), dO; and
    the plain backward's inputs: a fully masked row's gradients are zero on
    the card (the plain formula gives NaN there, ROADMAP C), so the plain
    one takes that row unmasked with dO = o = 0, which adds nothing."""
    from demucs_tpu_torch.kernels import attention as K

    q, k, v, mask = _sparse_case(mask_type, Tq, Tk, bf16=dtype == torch.bfloat16, B=B)
    do = _randn(B, Tq, 512, seed=94).to(dtype)
    forward = K._forward_bf16 if dtype == torch.bfloat16 else K._forward_f32
    o, lse = forward(q, k, v, H, K.mask_tiles(mask), rate, 5, True)
    empty = ~mask.bool().any(1)
    plain_mask = mask.bool() | empty[:, None]
    o_p, do_p = (t.masked_fill(empty[None, :, None], 0) for t in (o, do))
    want = K.flash_mha_bwd_plain(q, k, v, o_p, do_p, H, mask=plain_mask, dropout=rate,
                                 dropout_seed=5)
    return q, k, v, o, do, lse, mask, want


def _bwd_close(got, want, dtype):
    tol = 2 ** -6 if dtype == torch.bfloat16 else 1e-4
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        assert (g.float() - w.float()).abs().max() <= tol * w.float().abs().max()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Tq,Tk", MASKED_BWD_SHAPES)
@pytest.mark.parametrize("mask_type", MASK_CASES)
def test_masked_backward_matches_plain(cuda, monkeypatch, mask_type, Tq, Tk, rate):
    """Both routes' masked backward instances (fp32; bf16 at 64 and 128 keys
    a block) under each static mask, "holes" (an empty key block, empty
    query tiles, fully masked rows) and "bare", at the released shapes and a
    ragged one, at dropout 0 and 0.1, against the plain backward: 1e-4 (fp32)
    and 2**-6 (bf16) of each gradient's peak; counted as masked launches."""
    from demucs_tpu_torch.kernels import attention as K

    for dtype, keys in MASKED_BWD_ROUTES:
        monkeypatch.setattr(K, "BWD_KEYS_BF16", keys)
        q, k, v, o, do, lse, mask, want = _masked_bwd_case(mask_type, Tq, Tk, dtype, rate)
        backward = K.flash_mha_bwd_bf16 if dtype == torch.bfloat16 else K.flash_mha_bwd
        before = backward.masked_launches
        got = backward(q, k, v, o, do, 8, lse=lse, mask=mask, dropout=rate, dropout_seed=5)
        torch.cuda.synchronize()
        assert backward.masked_launches == before + 1
        _bwd_close(got, want, dtype)


@pytest.mark.parametrize("Tq,Tk", [(2688, 2688), (1001, 1337)])
@pytest.mark.parametrize("mask_type", MASK_CASES)
def test_masked_backward_repeats_under_deterministic(cuda, monkeypatch, deterministic, mask_type,
                                                     Tq, Tk):
    """Under torch.use_deterministic_algorithms the masked instances add each
    query tile's dQ parts in the order the tile map's turns give (the unmasked
    order restricted to the blocks that visit the tile): two launches
    bit-equal, within tolerance of the plain backward, and the launch's grid
    as the CPU twin plans it."""
    from demucs_tpu_torch.kernels import attention as K

    for dtype, keys in MASKED_BWD_ROUTES:
        monkeypatch.setattr(K, "BWD_KEYS_BF16", keys)
        q, k, v, o, do, lse, mask, want = _masked_bwd_case(mask_type, Tq, Tk, dtype, 0.1, B=2)
        backward = K.flash_mha_bwd_bf16 if dtype == torch.bfloat16 else K.flash_mha_bwd
        first, second = (backward(q, k, v, o, do, 8, lse=lse, mask=mask, dropout=0.1,
                                  dropout_seed=5) for _ in range(2))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        _bwd_close(first, want, dtype)
        plan = K.bwd_plan(dtype, keys or 64, 2, Tq, Tk, 8, 64, masked=True)
        assert plan["twin_agrees"] and plan["stagger"]


@pytest.mark.parametrize("deterministic_flag", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Tq,Tk", [(2688, 2688), (1001, 1337)])
@pytest.mark.parametrize("mask_type", MASK_CASES)
def test_masked_backward_d128_matches_plain(cuda, request, mask_type, Tq, Tk, rate,
                                            deterministic_flag):
    """The D = 128 masked backward (4 heads of 128 channels; fp32: the dK /
    dV and dQ kernels over the backward's and the forward's tile maps; bf16:
    its one plan of 64 keys) under each static mask and "holes" and "bare",
    at dropout 0 and 0.1, against the plain backward (1e-4, 2**-6 x each
    gradient's peak), by default and under the deterministic flag (then two
    launches bit-equal); counted as launches of the masked D = 128
    instance."""
    from demucs_tpu_torch.kernels import attention as K

    if deterministic_flag:
        request.getfixturevalue("deterministic")
    instance = "D=128 masked" + (" deterministic" if deterministic_flag else "")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, o, do, lse, mask, want = _masked_bwd_case(mask_type, Tq, Tk, dtype, rate, B=2,
                                                           H=4)
        backward = K.flash_mha_bwd_bf16 if dtype == torch.bfloat16 else K.flash_mha_bwd
        before = backward.launches_by_instance[instance]
        first, second = (backward(q, k, v, o, do, 4, lse=lse, mask=mask, dropout=rate,
                                  dropout_seed=5) for _ in range(2))
        torch.cuda.synchronize()
        assert backward.launches_by_instance[instance] == before + 2
        _bwd_close(first, want, dtype)
        if deterministic_flag:
            assert all(torch.equal(a, b) for a, b in zip(first, second))
            if dtype == torch.bfloat16:
                plan = K.bwd_plan(dtype, 64, 2, Tq, Tk, 4, 128, masked=True)
                assert plan["twin_agrees"] and plan["stagger"]


def test_masked_backward_tile_order_is_walk_order(cuda, deterministic):
    """A mask whose every unit is kept gives the masked deterministic
    instances the unmasked order exactly: the same dQ bit for bit as the unmasked
    ordered instances."""
    from demucs_tpu_torch.kernels import attention as K

    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (_randn(2, T, 512, seed=s).to(dtype) for s, T in
                       enumerate((1344, 2688, 2688, 1344)))
        mask = torch.ones(1344, 2688, dtype=torch.bool, device="cuda")
        forward = K._forward_bf16 if dtype == torch.bfloat16 else K._forward_f32
        o, lse = forward(q, k, v, 8, None, 0.0, 0, True)
        backward = K.flash_mha_bwd_bf16 if dtype == torch.bfloat16 else K.flash_mha_bwd
        masked = backward(q, k, v, o, do, 8, lse=lse, mask=mask)
        plain = backward(q, k, v, o, do, 8, lse=lse)
        assert all(torch.equal(a, b) for a, b in zip(masked, plain))


def test_masked_backward_instances_do_not_spill(cuda):
    """nvcc's report of the masked backward's library: every block-kernel
    instance (both routes, default and deterministic, every head dim and
    bf16 block; at head dim 128 the bf16 route's one block) without
    spills."""
    import re

    from demucs_tpu_torch.kernels import _build
    from demucs_tpu_torch.kernels import attention as K

    K._bwd_masked_lib()
    report = _build.ptxas_report("flash_mha_bwd_masked")
    kernels, spills, name = set(), [], None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1) if "bwd_kernel" in entry.group(1) else None
            if name:
                kernels.add(name)
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if name and found and (int(found.group(1)) or int(found.group(2))):
            spills.append(name)
    assert len(kernels) == 20 and not spills, (sorted(kernels), spills)  # 18, D = 128's 2
    assert all("ELb1EE" in n for n in kernels)  # every instance the MASKED one


def test_unmasked_backward_sass_unchanged(cuda):
    """The unmasked backward's block kernels at d = 64 (both routes, both
    bf16 blocks, default and deterministic) compile to the SASS opcode counts
    recorded from the tree before the masked instances
    (tests/k3_bwd_sass_opcodes.json, from ``chip_smoke.py --k3-pair``'s
    cuobjdump on an H100): the masked code, under ``if constexpr``, leaves
    the kernels that unmasked launches run as they were."""
    import json
    from pathlib import Path

    from chip_smoke import _sass_counts
    from demucs_tpu_torch.kernels import _build
    from demucs_tpu_torch.kernels import attention as K

    K._bwd_lib()
    recorded = json.loads((Path(__file__).parent / "k3_bwd_sass_opcodes.json").read_text())
    counts, _ = _sass_counts(Path(_build.nvcc_path()).with_name("cuobjdump"),
                             _build.library_path("flash_mha_bwd"),
                             {k.split()[0]: "ordered" for k in recorded["opcodes"]})
    assert counts == recorded["opcodes"]


# ---- K3 at any head dim up to 128: the D = 128 instances, the others padded ----

HEAD_DIM_CASES = (16, 24, 40, 96, 128)


@pytest.mark.parametrize("keys", [64, 128])
def test_flash_mha_bf16_tiles_d128(cuda, keys):
    """One S tile and one P V tile at head dim 128 (two 128-byte boxes a row),
    as test_flash_mha_bf16_tiles."""
    from demucs_tpu_torch.kernels import attention as K

    q = _randn(64, 128, seed=160).bfloat16()
    k, v = (_randn(keys, 128, seed=s).bfloat16() for s in (161, 162))
    p = torch.rand(64, keys, generator=torch.Generator().manual_seed(163)).to(cuda)
    s_tile, o_tile = K.bf16_tiles(q, k, v, p)
    torch.cuda.synchronize()
    want_s = q.double() @ k.double().T
    want_o = p.bfloat16().double() @ v.double()
    assert (s_tile.double() - want_s).abs().max().item() <= 1e-5 * want_s.abs().max().item()
    assert (o_tile.double() - want_o).abs().max().item() <= 1e-5 * want_o.abs().max().item()


@pytest.mark.parametrize("shape", ["ragged", "one query"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d", HEAD_DIM_CASES)
def test_flash_mha_head_dims_match_plain(cuda, monkeypatch, d, bf16, masked, shape):
    """Each head dim on its instance (128) or padded to the next one, on both
    routes, unmasked and under a mask: ragged at B = 2 with three heads (a
    fully masked key tile, row block and row), and one query over 70 keys at
    B = 3 with one head (masked, its only row fully masked: NaN everywhere).
    One launch of the instance, against the plain version (never reached by
    a CUDA tensor inside the wrapper)."""
    from demucs_tpu_torch.kernels import attention as K

    B, Tq, Tk, H = (2, 333, 517, 3) if shape == "ragged" else (3, 1, 70, 1)
    q, k, v = (_randn(B, T, H * d, seed=s) for s, T in ((170, Tq), (171, Tk), (172, Tk)))
    if bf16:
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    mask = None
    if masked:
        mask = _randn(Tq, Tk, seed=173) > 0.0
        mask[:, :64] = False
        mask[128:256] = False
        mask[min(7, Tq - 1)] = False
    want = K.flash_mha_plain(q, k, v, H, mask=mask)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(K, "flash_mha_plain", refuse)
    counter = K.flash_mha_bf16 if bf16 else K.flash_mha
    instance = f"D={K.instance_dim(d)}" + (" masked" if masked else "")
    before = (counter.launches, counter.launches_by_instance[instance])
    got = K.flash_mha(q, k, v, H, mask=mask)
    torch.cuda.synchronize()
    assert (counter.launches, counter.launches_by_instance[instance]) == (before[0] + 1,
                                                                          before[1] + 1)
    assert got.shape == want.shape and got.dtype == q.dtype
    _masked_close(got, want, BF16_TOL if bf16 else dict(atol=2e-5, rtol=1e-4))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d", [16, 40, 96, 128])
def test_flash_mha_padded_backward_matches_plain(cuda, d, bf16):
    """A gradient at a head dim padded to an instance (96 to 128; 128 its
    own): the backward kernel of the pad's instance, the gradients cropped,
    against autograd through the plain version (1e-4 / 2^-6 x each
    gradient's peak)."""
    from demucs_tpu_torch.kernels import attention as K

    H = 3
    ts = [_randn(2, T, H * d, seed=s) for s, T in ((174, 300), (175, 200), (176, 200))]
    do = _randn(2, 300, H * d, seed=177)
    dtype = torch.bfloat16 if bf16 else torch.float32
    xs = [t.to(dtype).requires_grad_() for t in ts]
    counter = K.flash_mha_bwd_bf16 if bf16 else K.flash_mha_bwd
    before = counter.launches
    got = torch.autograd.grad(K.flash_mha(*xs, H), xs, do.to(dtype))
    assert counter.launches == before + 1
    ref = [t.to(dtype).float().requires_grad_() for t in ts]
    want = torch.autograd.grad(K.flash_mha_plain(*ref, H), ref, do.to(dtype).float())
    rtol = 2.0 ** -6 if bf16 else 1e-4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g.float() - w).abs().max().item() <= rtol * w.abs().max().item()


def test_flash_mha_head_dims_refused(cuda):
    """Past 128 no instance: the forward, with a gradient or dropout too,
    and the backward raise before any launch, naming ROADMAP Queue C. A
    gradient and dropout at 96 and 128 launch the D = 128 instances."""
    from demucs_tpu_torch.kernels import attention as K

    before = (K.flash_mha.launches, K.flash_mha_bf16.launches, K.flash_mha_bwd.launches)
    q = _randn(1, 40, 2 * 136)
    for kw in ({}, dict(dropout=0.1, dropout_seed=3)):
        with pytest.raises(ValueError, match="head dims up to 128.*ROADMAP Queue C"):
            K.flash_mha(q.clone().requires_grad_(), q, q, 2, **kw)
    with pytest.raises(ValueError, match="head dims up to 128.*ROADMAP Queue C"):
        K.flash_mha_bwd(q, q, q, q, q, 2, lse=torch.zeros(2, 40, device=q.device))
    assert (K.flash_mha.launches, K.flash_mha_bf16.launches, K.flash_mha_bwd.launches) == before
    for d in (96, 128):
        q = _randn(1, 40, 2 * d)
        x = q.clone().requires_grad_()
        torch.autograd.grad(K.flash_mha(x, q, q, 2), x, q)
        b = q.bfloat16()
        K.flash_mha(b, b, b, 2, dropout=0.1, dropout_seed=3)
    torch.cuda.synchronize()
    assert (K.flash_mha.launches, K.flash_mha_bf16.launches, K.flash_mha_bwd.launches) == (
        before[0] + 2, before[1] + 2, before[2] + 2)


def test_registered_op_at_head_dim_96_under_export(cuda, tmp_path):
    """HTDemucs whose transformer has heads of 96 channels (384 in 4): its
    core exported with K3 as the registered op, loaded, and run on the card,
    where the op pads to the D = 128 instance: equal to the eager core (1e-6
    x peak) and launching the D = 128 instance."""
    import copy

    from demucs_tpu_torch.export import core as C
    from demucs_tpu_torch.kernels import attention as KA
    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs
    from demucs_tpu_torch.ops.spec import cac_pack, demucs_spec

    cfg = HTDemucsConfig(channels=16, depth=4, nfft=2048, t_layers=2, t_heads=4, segment=0.5,
                         samplerate=8000, bottom_channels=384)
    model = init_htdemucs(cfg, seed=9, layer_scale=1.0, random_norms=True).eval()
    card = copy.deepcopy(model).to(cuda)
    C.save_core(C.export_program(card), cfg, tmp_path / "core.pt2")
    core = C.load_core(tmp_path / "core.pt2", "cuda")
    mix = _randn(1, 2, 4000, seed=14) * 0.1
    mag = cac_pack(demucs_spec(mix, cfg.nfft))
    with torch.inference_mode():
        want = card.forward_core(mag, mix)
    before = KA.flash_mha.launches_by_instance["D=128"]
    got = core(mag, mix)
    torch.cuda.synchronize()
    assert KA.flash_mha.launches_by_instance["D=128"] == before + 4
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-6 * w.abs().max().item()


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_mha_bf16_masked_past_the_row_block_limit(cuda, rate):
    """A bf16 masked call past MASK_ROW_BLOCKS row blocks at the largest
    plan's rows (192) launches in pieces of its rows instead of raising, and
    gives the plain version's result; with dropout each piece hashes its
    global rows, so the pieces drop what the plain version drops. Its
    gradients (the masked backward, one launch over every row, which hashes
    the global rows too) against the plain backward's, 2**-6 x each
    gradient's peak (a fully masked row as _masked_bwd_case takes it)."""
    from demucs_tpu_torch.kernels import attention as K

    Tq, Tk = K.MASK_ROW_BLOCKS * 192 + 5, 256
    q = _randn(1, Tq, 64, seed=180).bfloat16().requires_grad_()
    k, v = (_randn(1, Tk, 64, seed=s).bfloat16().requires_grad_() for s in (181, 182))
    do = _randn(1, Tq, 64, seed=185).bfloat16()
    mask = _randn(Tq, Tk, seed=183) > 0.0
    mask[3] = False
    before = K.flash_mha_bf16.launches
    got = K.flash_mha(q, k, v, 1, mask=mask, dropout=rate, dropout_seed=184)
    torch.cuda.synchronize()
    assert K.flash_mha_bf16.launches == before + len(K.mask_pieces(Tq)) == before + 2
    with torch.no_grad():
        want_o = K.flash_mha_plain(q, k, v, 1, mask=mask, dropout=rate, dropout_seed=184)
    _masked_close(got.detach(), want_o, BF16_TOL)
    before = K.flash_mha_bwd_bf16.masked_launches
    got.backward(do)
    torch.cuda.synchronize()
    assert K.flash_mha_bwd_bf16.masked_launches == before + 1
    empty = ~mask.any(1)
    o_p, do_p = (t.detach().masked_fill(empty[None, :, None], 0) for t in (got, do))
    want = K.flash_mha_bwd_plain(q.detach(), k.detach(), v.detach(), o_p, do_p, 1,
                                 mask=mask | empty[:, None], dropout=rate, dropout_seed=184)
    _bwd_close((q.grad, k.grad, v.grad), want, torch.bfloat16)
