#!/usr/bin/env python3
"""Drive demucs_tpu_torch on one NVIDIA GPU and check it, phase by phase.

    python3 chip_smoke.py          # from the root of a checkout, one card
    python3 chip_smoke.py --k3-pair PARENT .   # K3 of two checkouts, timed in turns
                                               # (masked too: sparse_kernels with pairs)

Phases, one JSON line each, each followed by a line with its seconds
(``phase_seconds``); any failure exits non-zero before the last line:

1. device   — the card (nvidia-smi name and power limit, printed as is on a
              line of its own) and the build of every CUDA kernel from
              demucs_tpu_torch/csrc, one nvcc per source, in parallel.
2. kernels  — K1 (STFT), K2 (iSTFT) and K3 (attention, fp32 and bf16) at the shapes the
              released HTDemucs gives them for one 7.8 s segment, on the card,
              against their plain PyTorch versions on the same inputs with TF32
              off; also at the shapes of the served 6-segment batch. K2 at each
              number of output chunks per block; K3 at its four shapes (freq and
              time tokens, self and cross) at both batches, each at 64 and 128
              query rows per block, and with a keep-mask whose first key tile
              and one query row are fully masked. K1 and K2 also at one and two
              44 s HDemucs segments (1899 frames). K3's bf16 route: one S and
              one P V tile alone at each head dim and key tile (exact bf16
              products), then the four shapes at both batches on bf16 inputs
              against the plain version, beside SDPA in bf16, with the sweep of
              its plans (keys per tile x rows per block x the persistent
              schedule or a block per row block) and the plan chosen, a ragged
              batch, the masked case, and each instance's registers and
              spills (nvcc's report kept beside the library). K3 at head dims
              16, 24, 40, 96 (padded) and 128 on both routes, masked or not,
              against the plain version at a ragged shape and (d = 128) at one
              query over 70 keys; the D = 128 instances timed at freq self
              (4 heads, B = 1 and 6) and held to the plain version there.
   sparse_kernels — K3 under each static sparse mask (diag, global, jmask,
              random, diag_jmask_random at the reference's window 500, global
              100, sparsity 0.95) at the four shapes and both batches: the fp32
              route and every bf16 plan against the plain version (NaN only
              where it has NaN), ms beside the unmasked ms and SDPA with the
              same mask, each route's plan's share of non-empty and of full
              (row block, key tile) units, the launched instance's registers
              and spills (none may spill); then K3's backward under each mask
              on both routes at the four shapes and B = 1 and 8 (the masked
              instances: a tile map per plan, bits on partial units) beside
              the same shape unmasked and SDPA's backward with the same mask,
              each plan's non-empty and full unit shares, the instances'
              registers and spills, and at B = 1 the plain formula, by
              default and under the flag (two launches bit-equal).
              Times the kernel, the plain version and one PyTorch library call
              computing the same function (yardstick only: the port never calls
              it), with CUDA events. Then drops the plain versions' cached dense
              bases, which serving never builds.
3. model    — the released-width HTDemucs (channels 48, nfft 4096,
              bottom_channels 512, 5 layers, 8 heads, dconv_mode 3) with random
              weights from a seeded torch.Generator, every LayerScale at 1.0
              (at their 1e-4 init the transformer's branches would hide below the
              tolerance) and random norm weights and biases (at 1 and 0 a norm
              left out would hide), one 1.0 s segment through HTDemucs.forward
              on the card and on the CPU (plain versions).
4. serving  — a Separator on the card with the 7.8 s model, loaded from a .dmx
              saved from the phase-3 weights, answers three requests (30 s, 12 s
              and 5 s synthetic stereo tracks at 44.1 kHz, each 3 times) on each
              engine, after one warm-up request of each length on each (cuDNN and
              cuBLAS set-up, every CUDA graph captured): the device engine,
              Separator's default, whose forwards must all be graph replays, and
              the host engine (engine="host"). Per engine: audio-s/s, peak memory,
              and every kernel's launches (the wrappers' counts plus each replay's
              captured launches) equal to what the batched forwards predict (K1
              and K2 once each, K3 ten times). Each device-engine request's stems
              against the host engine's for the same shift, 1e-5 x peak. Then one
              more 30 s request on the host engine: its batched forward of 6
              segments is held against the same weights on the CPU.
   graphs   — the graphs captured (count, warm-up and capture seconds, the
              shared pool's bytes), and a replay at B = 6 and B = 1 against an
              eager forward on a fresh input: bit-equal or not, 1e-6 x peak.
   pipelined — three tracks through apply_model_tracks against one call per
              track with the same random.Random: bit-equal.
   wire     — a 30 s request on the device engine with the stems' int16 and
              float16 wires (the CLI's defaults for 16-bit and for other
              output) against the float32 wire: the error in steps of the
              int16 grid (1/32766 of each stem channel's peak); int16 must
              stay within half a step, plus float32 rounding (0.51).
   profile  — a 30 s and a 5 s request per engine under torch.profiler: device
              time by kernel group, the stems' copy to the host, and the
              device's busy share of the wall time.
5. bag      — 4 released-width members (distinct seeds, htdemucs_ft's one-hot
              weights) on a 30 s track with shifts=2: the device engine against
              the host engine, 1e-5 x peak, with launch counts for each.
6. hdemucs  — the released HDemucs (hdemucs_mmi's shape: channels 48, depth 6,
              nfft 4096, BLSTM and LocalState in the DConv branches from depth
              4) at the bags' 44 s segment, seeded random weights, unit
              LayerScales, random norms: the forward on the card against a CPU
              copy (2 s); a Separator from a .dmx answering a 30 s request (one
              exact tail, eager) and a 60 s one (a graph replay of the full
              windows and an eager tail) 2 times each on each engine, with
              launches against the forwards, the device engine's stems against
              the host engine's, graphs, peak memory, and one profiled 60 s
              request on the device engine (cuDNN's RNN a group of its own).
7. demucs_v2 — the same for the released Demucs v2 widths (channels 64, depth 6).
8. wiener   — apply_wiener (1 iteration) at one 44 s segment's spectrogram, and
              the MDX-era HDemucs (hybrid_old, cac=False, Wiener 1 iteration),
              card against CPU.
9. zoo      — a folder in the reference's formats with repro_mdx_a's shape: two
              Demucs v2 and two MDX-era HDemucs .th packages (torch.save of
              {klass, args, kwargs, state}, fp16 state, stub demucs classes), one
              diffq-quantized, and a bag file (segment 44): Separator(model=bag,
              repo=folder) on the card holds the written weights, and a 30 s
              request gives the same stems on both engines.
10. engines — the device engine against the host engine past one segment
              (HDemucs and Demucs v2 at 60 s, the bag at 30 s, a pinned shift):
              as served, each engine twice, and with the same windows per
              forward under deterministic cuDNN; one full window's forward at
              B = 1, B = 2 and from a graph at B = 2.
11. presets — default, fast, balanced and quality (presets.py) on HTDemucs
              (released widths, 30 s, median of 3) and on HDemucs and Demucs v2
              (30 s, median of 3), device engine: audio-s/s, SER against the
              family's fp32 forward (bounded per preset), peak memory, the
              graph pool, launches (K3's bf16 route on HTDemucs's fast path);
              one profiled 30 s request on HTDemucs's fast preset (K3 bf16's
              share of the device time); C4: the fast preset's two eager
              forwards and two graph replays bit-equal, and its audio-s/s
              with and without the deterministic transposed convolutions.
12. prewarm — HDemucs at 30 and 60 s, each part on a model loaded anew:
              random shifts, a cold pinned offset, then prewarm() and requests
              with the pinned set it warmed (no capture after it).
13. codecs  — on the host: which of libmp3lame, libmpg123, the libavcodec
              headers and libraries (the avio shim) and the ffmpeg binaries this
              machine has (absent is printed, not failed); a 30 s stereo track
              written and read as FLAC at 16 and 24 bits (bit-exact) and, with
              LAME, as mp3; the ms of each step.
   automix  — on the host, no card: python -m demucs_tpu_torch.automix on a
              synthetic MusdbHQ folder of three 6 s songs (beat tracking,
              chroma, matching, repitch, alignment): one song out per song
              in, five finite WAVs of one length each, the seconds.
14. serve   — SeparationService (the phase-4 HTDemucs .dmx, pinned shift
              offsets) behind make_server on 127.0.0.1, port 0, in a thread: 30 s
              bodies as WAV, FLAC and (with LAME and a decoder) mp3, and
              responses as wav, flac and (with LAME) mp3, each once after a
              warm-up: audio-s/s and the wall split into body decode, separation,
              and encode plus zip; launches over them. The float32 WAV response
              against Separator.separate_tensor on the decoded body, bit for bit;
              ?shifts=0 then a parameterless request (nothing leaks); a truncated
              and an ADTS-headed body get error statuses and the next request is
              answered.
15. streaming — StreamSeparator over HTDemucs (30 s) and Demucs v2 (44 s
              segment, 60 s) fed in ragged chunks from a seed: against
              apply_model(shifts=0) on the card (1e-5 x peak) and its graph
              replays against an all-eager stream (1e-6 x peak); replays and
              eager tails, ms per segment, latency, real-time factor, launches.
16. variants — the released-width HTDemucs with each remaining option
              (VARIANTS: static sparse self- and cross-attention with the diag
              mask and with diag_jmask_random, LSH, CAPE, cac=False with Wiener,
              multi_freqs), one 7.8 s segment on the card against the CPU
              (2e-4 x peak); the LSH variant instead by the share of keep-mask
              entries the card flips against the CPU on the same q and k, two
              card forwards bit-equal and finite stems. Then a 30 s request on
              the device engine for the dense, both sparse, the LSH and the
              fast-preset sparse model (K3's bf16 route): audio-s/s, launches
              (K3 10 a forward on the sparse paths, none on LSH's dense route),
              memory.
17. memory  — pass_memory_analysis for a 30 s request against the same
              request measured cold and warm; the graphs' pool before and after
              GRAPHS.clear() with torch.cuda.empty_cache(), and a request after
              it (recaptured, the same stems).
18. evaluate — evaluate(compute_sdr=True) on a synthetic 1-track x 10 s
              MusdbHQ folder with the phase-4 model: each track's nsdr against
              eval_track on Separator's stems, seconds per track for the
              separation on the card and BSS-eval on the host.
19. train   — training: K3's backward kernel (flash_mha_bwd) and K3's forward
              with the hashed dropout against their plain versions at the four
              shapes, B = 1 and 8, unmasked and under the diag mask, at dropout 0
              and 0.1, each case also under torch.use_deterministic_algorithms
              (its ordered kernel against the same plain gradients), timed
              beside SDPA's fp32 backward and forward, each with and without
              its dropout; K2's backward (K1's
              kernel with the per-bin scale) and K1's (K2's kernel) against
              their plain versions and autograd through the plain twins, at the
              training shapes and the HDemucs 44 s ones; one train step of the
              released-width HTDemucs at batch 1 on the card against the CPU
              (loss, reco, the gradient's global norm, every gradient), the
              card's step run once by default and twice under
              torch.use_deterministic_algorithms (C5: bit-equal gradients),
              each way against the CPU; K3's backward under the flag timed and
              rerun bit-equal at every shape beside the default, with the
              cooperative grid, order, rounds of heads and dQ ring that its
              launch reports (and whether the CPU twin agrees); the
              training rate: train_step at batch 8 (4 if 8 does not fit), 6
              steps with every launch counted (the train path), training
              audio-s/s over steps 3-6, the forward / backward / optimizer
              split, peak memory and one profiled step; then python -m
              demucs_tpu_torch.train on a synthetic wav folder, killed after
              epoch 1's checkpoint and resumed for epoch 2 (the resumed
              process reports its launches: the train entry path), and the
              best model separating a 10 s track through Separator on the
              card. bf16
              mixed precision beside it: K3's bf16 forward with the hashed
              dropout and each row's log-sum-exp, its drop pattern bit for bit
              and its backward kernel (flash_mha_bwd_bf16) against the plain
              versions at the same shapes (every case and both block sizes
              also under the flag), every plan of the forward at dropout 0.1
              (time, plain, pattern), the dropout instances' registers and
              spills, timed beside SDPA in bf16 (its dropout too); the bf16
              step of the same model and batch, card against CPU, the card's
              run once by default and twice under the flag (bit-equal; the
              two are the train bf16 deterministic path), each way against
              the CPU; C2's probe
              (the fp32 step's gradients on the card, with cuDNN deterministic
              and with remat, and on the CPU, against the step in float64 on
              the CPU); the bf16 training rate (the train bf16 path's
              launches); and the entry point for one epoch with
              compute_dtype bfloat16 and t_dropout 0.1 in a process of its
              own that reports its launches (the train bf16 entry path).
              The sparse path (HTDemucs with static masks in every self and
              cross layer, diag at the reference's defaults, K3's backward
              the masked instances): its card step against the CPU's in fp32
              and in bf16, each also twice under the flag (bit-equal), and 5
              steps at batch 8 beside the dense step (the train sparse and
              train sparse bf16 paths).
   train_recipe — the reference's default recipe: demucs_tpu_torch.train's
              main (python -m demucs_tpu_torch.train) in this process at the
              released width, every augment at its default (repitch 0.2, the
              backend named), 11 s windows shifted by up to 1 s, 2 batches x 2
              epochs with every launch counted (the train recipe path), then
              an epoch with every item repitched and one with none: the data
              waits at repitch 0, 0.2 and 1, the batch loop's device idle share
              (torch.profiler) at 0.2 and 1, and ms per repitched 11 s item at
              each pitch. Then the step with the SVD penalty (low-rank, the
              power method), with DiffQ and with QAT at 8 bits against the
              plain step (launches per option), the exact penalty on the card
              against the CPU's, each quantized export through Separator on
              the card with its SER against the float model on 10 s, and the
              C++ WAV window reader against the Python reader (ms, bit-equal)
              with its prefetcher's examples.
   export   — the released HTDemucs's core (7.8 s) through torch.export with
              K3 as the registered op demucs_tpu_torch::flash_mha: exported on
              the card and on the CPU (then moved to the card), the two op
              lists equal, each saved and loaded (seconds, MB), against the
              eager forward_core (1e-6 x peak); the artifact runtime
              (export/run.py: K1, the program, K2, the overlap-add) on a 30 s
              track, its audio-s/s beside apply_model(shifts=0)'s (scale
              only: the runtime has no CUDA graph), its stems against
              apply_model's (1e-5 x peak) and its launches (K1 and K2 once,
              K3 ten times a segment); the fast preset's artifact against its
              eager core under cuDNN's deterministic mode (1e-5 x peak; two
              eager forwards of the fast preset differ by its default bf16
              algorithms, printed as eager_rerun) and its runtime on K3's
              bf16 route;
              torch.library.opcheck of the op on CUDA fp32 and bf16 tensors;
              export/release.py on the train phase's XP (the 8-hex name, the
              trained segment, the checkpoint's weights in fp16).
   parallel — one card: the probe through the port's launcher (one NCCL
              rank; two Gloo ranks on cuda:0, whose rank task, ``python -m
              chip_smoke --rank-task dp_gloo DIR``, runs it first:
              all_reduce, share, the collectives on the card's tensors);
              the released HTDemucs at a global batch of 8: world 1 on NCCL
              (a group of one in this process) and two Gloo ranks against
              one process (losses and gradients after 2 steps; gradients on
              mse; the one-process step run twice and world 1 under
              torch.use_deterministic_algorithms, the two runs bit-equal;
              the step without the flag and under it on one model, timed
              and profiled: the device ms each kernel group gains under it);
              HDemucs and Demucs v2 (2 steps at 4, two ranks against
              one process; one step card vs CPU); the Gloo ranks then train
              through the entry point, stopped after epoch 1, and the
              launcher resumes it (rank 0 alone writes, equal summaries);
              segments and a 4-member bag over device lists naming cuda:0
              2 and 4 times against the one-device engine, launches against
              the forwards; tp_forward on two ranks against one device.
              Times are the paths' cost on one card, not scaling.
20. cli     — python -m demucs_tpu_torch on a WAV file with the HTDemucs .dmx,
              then -n <bag> --repo <folder> on a 48 kHz FLAC file (resampled)
              with --flac, then (with LAME) the .dmx with --mp3.

Then the ``kernels`` line (K1, K2, K3 on fp32 and K3 on bf16, K3's backward
on each route, unmasked and masked (the masked instances' launches on the
train sparse paths), and K2's backward, each kernel's launches on every path:
HTDemucs, HDemucs, Demucs v2, the bag, each family's presets, the server,
each stream, each variant request, the fp32 and bf16 train paths, the
default recipe's entry point and each training option's steps, the export
runtime's default and fast runs, the parallel paths; ``launches``
is their sum)
and, last,
``{"ok": true, "device": {...}}``.
Bounds use the published peaks of one H100 SXM: 67 TFLOP/s in fp32 on the
CUDA cores, 495 TFLOP/s in TF32 on the tensor cores and 3.35 TB/s of HBM;
the card's power limit is printed beside. A bound is the larger of the
operations over their peak and the bytes over the HBM rate. K1 and K2 count
the least work of the function, not of the kernel's algorithm: the signal
and the spectrum moved once and the operations of a real FFT (2.5 n log2 n
per frame, plus the window and the overlap-add), in fp32. K3's bound
counts the function's bytes (q, k, v and o once; the K/V image the kernel
lays out is its own cost, not the function's) and its route's operations,
three TF32 products per matmul on the tensor cores (3xTF32, which keeps fp32
accuracy): 3 x 4 B H Tq Tk d over 495 TFLOP/s. Beside it, each K3 shape
also gives ``fn_bound_ms``, the function's own 4 B H Tq Tk d operations at
the TF32 peak, which no fp32-accurate route reaches. K3's bf16 route counts
4 B H Tq Tk d over 989 TFLOP/s (bf16 on the tensor cores) against its bf16
bytes; its backward 5 x 2 B H Tq Tk d over 989 TFLOP/s (the fp32 backward:
three times that over 495).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import itertools
import json
import math
import os
import subprocess
import sys
import time
import traceback
import typing as tp
import wave
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM, TF32 on the tensor cores, dense
BF16_FLOPS = 989e12  # H100 SXM, bf16 on the tensor cores, dense
HBM_BYTES = 3.35e12  # H100 SXM HBM3
SR = 44100
RELEASED = dict(channels=48, depth=4, nfft=4096, t_layers=5, t_heads=8, dconv_mode=3,
                bottom_channels=512, samplerate=SR)
KERNEL_RTOL = 1e-4  # K1/K2: max |kernel - plain| <= 1e-4 x peak |plain| (fp32 sums of 4096+ terms)
K3_ATOL = 2e-5  # K3: max |kernel - plain| (the card test's atol; 1xTF32 would miss it 20-30x)
# K3's bf16 route: |kernel - plain| <= atol + rtol |plain|, a few bf16 steps of the output
# (tests/test_torch_attention.py BF16_FLASH, met by the model of the kernel's arithmetic)
K3_BF16_TOL = 2.0 ** -6
MODEL_RTOL = 2e-4  # card vs CPU forward, x peak (the repo's golden tolerance)
ENGINE_RTOL = 1e-5  # device engine vs host engine stems, x peak (the CPU tests' bound)
GRAPH_RTOL = 1e-6  # graph replay vs eager forward, x peak (the same kernels and inputs)
N_TIMED = 10
SPIN_CYCLES = 40_000_000  # about 20 ms at the H100's clocks: longer than 10 calls' launches
REPEATS = 3  # serving: each request size is answered this many times, median reported
FAMILY_REPEATS = 2  # the same for the HDemucs and Demucs v2 requests
FAMILY_LENGTHS = (30.0, 60.0)
CODEC_SECONDS = 30.0  # the codecs phase's track
SERVE_REPEATS = 1  # each served request kind
HDEMUCS = dict(channels=48, depth=6, nfft=4096, samplerate=SR)  # hdemucs_mmi (tests/common.py:64)
DEMUCS = dict(channels=64, depth=6, samplerate=SR)  # tests/common.py:65
MDX_HYBRID = dict(hybrid_old=True, cac=False, norm_starts=999)  # tools/convert.py:63-72



_START = time.perf_counter()
# cuBLAS under torch.use_deterministic_algorithms (the train and parallel phases' HTDemucs
# checks, C5) needs a fixed workspace, set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` inside, as it was after:
    K3's backward sums dQ in key-block order, cuDNN takes deterministic
    algorithms, and an op with none raises."""
    import torch

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


_LAST_PHASE_AT = [0.0]  # the script's seconds at the last phase line


def emit(obj) -> None:
    """One JSON line; a phase's line carries ``at_s``, the script's seconds so
    far, and is followed by a line of its own with the phase's seconds (since
    the phase line before it)."""
    if "phase" in obj:
        at = time.perf_counter() - _START
        obj = dict(obj, at_s=at)
        print(json.dumps(obj), flush=True)
        print(json.dumps({"phase_seconds": {obj["phase"]: at - _LAST_PHASE_AT[0]}}), flush=True)
        _LAST_PHASE_AT[0] = at
        return
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, repeat: int = N_TIMED, spin: bool = True) -> float:
    """Milliseconds per call of ``fn`` between CUDA events. With ``spin`` the
    calls queue behind a kernel that keeps the device busy while the host
    launches them, so this is device time: a call whose host side takes
    longer than its kernels (K1 at one segment) is not timed by its host."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(repeat):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeat


def fft_flops(n: int) -> float:
    """Operations of one real FFT of length n: half the 5 n log2 n of a complex one."""
    return 2.5 * n * math.log2(n)


def bound(flops: float, nbytes: float, peak: float = FP32_FLOPS) -> tuple:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device() -> dict:
    import torch

    from demucs_tpu_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    start = time.perf_counter()
    report = _build.build()
    build_s = time.perf_counter() - start
    info = {"phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s,
            "built": {k: {"seconds": round(v["seconds"], 2),
                          "ptxas": [line.strip() for line in v["ptxas"].splitlines()
                                    if "registers" in line or "spill" in line
                                    or "warning" in line.lower()]}
                      for k, v in report.items()}}
    emit(info)
    return info


def phase_kernels() -> list:
    import torch

    from demucs_tpu_torch.kernels import stft as KS
    from demucs_tpu_torch.models.htdemucs import precision_scope

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n_fft, hop, freqs = 4096, 1024, 2049
    # One 7.8 s segment (343980 samples): demucs_spec pads it to 351232
    # samples -> 340 frames; stereo -> 2 rows; 4 stems x 2 channels -> 8 rows.
    # The served 30 s request batches 6 segments: 12 and 48 rows. One 44 s
    # HDemucs segment (1940400 samples): 1947648 samples -> 1899 frames, and
    # its 60 s request batches 2 segments.
    window = torch.hann_window(n_fft, device=dev)
    rows = []

    def k1(batch, length=351232, n_frames=340):
        x = torch.randn(2 * batch, length, device=dev, generator=gen) * 0.3
        got = KS.stft_dft(x, n_fft, hop)
        want = KS.stft_dft_plain(x, n_fft, hop)
        frames = x.shape[0] * n_frames
        return dict(
            tol=KERNEL_RTOL * max(w.abs().max().item() for w in want),
            max_abs_err=max((g - w).abs().max().item() for g, w in zip(got, want)),
            ms=cuda_ms(lambda: KS.stft_dft(x, n_fft, hop)),
            call_ms=cuda_ms(lambda: KS.stft_dft(x, n_fft, hop), spin=False),
            plain_ms=cuda_ms(lambda: KS.stft_dft_plain(x, n_fft, hop)),
            library_ms=cuda_ms(lambda: torch.stft(x, n_fft, hop, window=window, center=False,
                                                  return_complex=True)),
            flops=frames * (n_fft + fft_flops(n_fft)),  # window, real FFT
            bytes=4 * (x.numel() + 2 * frames * freqs),
            shape=f"x {tuple(x.shape)} -> 2 x {tuple(got[0].shape)}")

    def k2(batch, n_frames=340, sweep=True):
        zr = torch.randn(8 * batch, n_frames, freqs, device=dev, generator=gen)
        zi = torch.randn(8 * batch, n_frames, freqs, device=dev, generator=gen)
        got = KS.istft_dft(zr, zi, n_fft, hop)
        want = KS.istft_dft_plain(zr, zi, n_fft, hop)
        z = torch.complex(zr, zi).transpose(1, 2)
        frames = zr.shape[0] * n_frames
        chosen = KS.istft_group(n_fft, hop)
        by_group = {}
        pick = KS.istft_group
        try:  # the same kernel with each number of output chunks per block
            for group in (1, 2, 4, 8, 16) if sweep else ():
                KS.istft_group = lambda *args, group=group: group
                by_group[group] = cuda_ms(lambda: KS.istft_dft(zr, zi, n_fft, hop))
        finally:
            KS.istft_group = pick
        return dict(
            tol=KERNEL_RTOL * want.abs().max().item(),
            max_abs_err=(got - want).abs().max().item(),
            ms=cuda_ms(lambda: KS.istft_dft(zr, zi, n_fft, hop)),
            call_ms=cuda_ms(lambda: KS.istft_dft(zr, zi, n_fft, hop), spin=False),
            plain_ms=cuda_ms(lambda: KS.istft_dft_plain(zr, zi, n_fft, hop)),
            library_ms=cuda_ms(lambda: torch.istft(z, n_fft, hop, window=window, center=True)),
            flops=frames * (fft_flops(n_fft) + 2 * n_fft),  # inverse real FFT, window, add
            bytes=4 * (2 * zr.numel() + got.numel()), group=chosen, ms_by_group=by_group,
            shape=f"2 x {tuple(zr.shape)} -> {tuple(got.shape)}")

    def at_44s(fn, batch):
        row = fn(batch, 1947648, 1899) if fn is k1 else fn(batch, 1899, sweep=False)
        row["bound_ms"], row["bound_by"] = bound(row["flops"], row["bytes"])
        torch.cuda.empty_cache()
        return row

    with precision_scope(None):
        for name, fn, replaces, library in (
                ("stft_dft", k1, "demucs_tpu/ops/pallas/stft.py:61", "torch.stft(center=False)"),
                ("istft_dft", k2, "demucs_tpu/ops/pallas/stft.py:137",
                 "torch.istft(center=True), which adds the envelope division and crop")):
            b1, b6 = fn(1), fn(6)
            b6["bound_ms"], b6["bound_by"] = bound(b6["flops"], b6["bytes"])
            hd = {f"B={b}": at_44s(fn, b) for b in (1, 2)}
            rows.append(dict(b1, name=name, source="demucs_tpu_torch/csrc/stft.cu",
                             replaces=replaces, library=library, batch_6=b6, hdemucs_44s=hd,
                             ok_6=all(r["max_abs_err"] <= r["tol"]
                                      for r in (b6, *hd.values()))))
        # The dense bases of the plain versions (134 MB) are built only for the
        # comparisons above; serving must not find them allocated.
        KS._stft_basis.cache_clear()
        KS._istft_basis.cache_clear()
        torch.cuda.empty_cache()
        rows.append(k3_checks(gen))
        rows.append(k3_bf16_checks(gen))
        rows += k3_head_dims_checks(gen)
    for row in rows:
        if "bound_ms" not in row:
            row["bound_ms"], row["bound_by"] = bound(row["flops"], row["bytes"])
        row["ok"] = (row.get("within_tol", row["max_abs_err"] <= row["tol"])
                     and row.get("ok_6", True))
    emit({"phase": "kernels", "rows": rows})
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return rows


def k3_checks(gen) -> dict:
    """K3 at the transformer's four shapes (freq 2688 and time 1344 tokens, self
    and cross; C 512, 8 heads of 64) for one segment and for the served batch
    of 6, each against the plain version and SDPA, with the sweep of query rows
    per block; then the masked case. TF32 is off."""
    import torch
    import torch.nn.functional as F

    from demucs_tpu_torch.kernels import attention as KA

    dev = torch.device("cuda")
    C, H = 512, 8
    d = C // H
    tokens = {"freq": 2688, "time": 1344}
    by_shape, sweep, err = {}, {}, 0.0
    pick = KA.BLOCK_ROWS
    for batch in (1, 6):
        for tq_name, tk_name in (("freq", "freq"), ("time", "time"), ("freq", "time"),
                                 ("time", "freq")):
            Tq, Tk = tokens[tq_name], tokens[tk_name]
            q = torch.randn(batch, Tq, C, device=dev, generator=gen)
            k = torch.randn(batch, Tk, C, device=dev, generator=gen)
            v = torch.randn(batch, Tk, C, device=dev, generator=gen)
            shape_err = (KA.flash_mha(q, k, v, H) - KA.flash_mha_plain(q, k, v, H)).abs().max()
            err = max(err, shape_err.item())
            split = [t.view(batch, -1, H, d).transpose(1, 2) for t in (q, k, v)]
            flops = 4 * batch * H * Tq * Tk * d
            nbytes = 4 * 2 * batch * (Tq + Tk) * C
            b_ms, b_by = bound(3 * flops, nbytes, TF32_FLOPS)
            key = f"B={batch} {tq_name}<-{tk_name}"
            by_shape[key] = dict(
                max_abs_err=shape_err.item(), ms=cuda_ms(lambda: KA.flash_mha(q, k, v, H)),
                sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(*split)),
                bound_ms=b_ms, bound_by=b_by, fn_bound_ms=bound(flops, nbytes, TF32_FLOPS)[0])
            if key == "B=1 freq<-freq":
                by_shape[key]["plain_ms"] = cuda_ms(lambda: KA.flash_mha_plain(q, k, v, H))
            try:
                for rows in (64, 128):
                    KA.BLOCK_ROWS = rows
                    sweep.setdefault(key, {})[f"{rows} rows"] = cuda_ms(
                        lambda: KA.flash_mha(q, k, v, H))
            finally:
                KA.BLOCK_ROWS = pick
    q = torch.randn(1, 2688, C, device=dev, generator=gen)
    k = torch.randn(1, 2688, C, device=dev, generator=gen)
    v = torch.randn(1, 2688, C, device=dev, generator=gen)
    mask = torch.ones(2688, 2688, dtype=torch.bool, device=dev)
    mask[:, :KA.KEY_TILE] = False  # the first key tile, fully masked for every row
    mask[7] = False  # a query row with no kept key: NaN, as the plain softmax gives
    got = KA.flash_mha(q, k, v, H, mask=mask)
    want = KA.flash_mha_plain(q, k, v, H, mask=mask)
    if not torch.isnan(got[0, 7]).all():
        raise AssertionError("K3: a fully masked row does not give NaN")
    mask_err = fp32_err(got, want)  # inf where NaN is not where the plain version has it
    main = by_shape["B=1 freq<-freq"]
    return dict(
        name="flash_mha", tol=K3_ATOL, max_abs_err=max(err, mask_err), masked_err=mask_err,
        source="demucs_tpu_torch/csrc/flash_mha.cu",
        replaces="demucs_tpu/ops/pallas/attention.py:103",
        ms=main["ms"], plain_ms=main["plain_ms"], library_ms=main["sdpa_ms"],
        library="F.scaled_dot_product_attention (fp32)",
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        bound_rule="max(3 x 4 B H Tq Tk d / 495 TFLOP/s (3xTF32 on the tensor cores), "
                   "bytes of q, k, v and o moved once / 3.35 TB/s)",
        fn_bound_rule="max(4 B H Tq Tk d / 495 TFLOP/s, the same bytes / 3.35 TB/s)",
        rows=KA.BLOCK_ROWS, by_shape=by_shape,
        rows_sweep_ms=sweep, shape="q, k, v (1, 2688, 512), 8 heads (freq self)")


BF16_PLANS = tuple(itertools.product((64, 128), (128, 192), (True, False)))


@contextlib.contextmanager
def bf16_plan(**plan):
    """K3 bf16's plan forced inside the block (module constants of
    kernels/attention.py: KEY_TILE_BF16, BF16_ROWS, BF16_PERSISTENT),
    restored after."""
    from demucs_tpu_torch.kernels import attention as KA

    old = {name: getattr(KA, name) for name in plan}
    try:
        for name, value in plan.items():
            setattr(KA, name, value)
        yield
    finally:
        for name, value in old.items():
            setattr(KA, name, value)


def ptxas_kernels(report: str, pattern: str) -> dict:
    """Registers and spills of each kernel whose mangled name matches
    ``pattern`` (groups: its template arguments), from nvcc -Xptxas=-v."""
    import re

    found, name = {}, None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            args = re.search(pattern, entry.group(1))
            name = " ".join(g for g in args.groups() if g is not None) if args else None
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if spill:
            found.setdefault(name, {}).update(spill_stores=int(spill.group(1)),
                                              spill_loads=int(spill.group(2)))
        if regs:
            found.setdefault(name, {})["registers_at_launch"] = int(regs.group(1))
    return found


def bf16_instances(report: tp.Optional[str] = None) -> dict:
    """Registers and spills of each instance of K3's bf16 kernel (d, keys per
    tile, rows per block, with or without the dropout, with or without a
    mask) from nvcc's report of the library loaded, or of ``report``."""
    from demucs_tpu_torch.kernels import _build

    found = ptxas_kernels(_build.ptxas_report("flash_mha") if report is None else report,
                          r"flash_mha_bf16_(masked_)?kernelILi(\d+)ELi(\d+)ELi(\d+)E"
                          r"(?:Lb([01])E)?")
    named = {}
    for key, v in found.items():
        words = key.split()
        masked = words[0] == "masked_"
        dd, bk, nwg, *drop = words[1:] if masked else words
        named[f"d={dd} keys={bk} rows={64 * int(nwg)}"
              + (" dropout" if drop and drop[0] == "1" else "") + (" masked" if masked else "")] = v
    return named


def bf16_excess(got, want) -> float:
    """K3 bf16 against its plain version: the max over finite ``want`` of
    |got - want| - tol (1 + |want|) (<= 0 passes; 0 where no value of
    ``want`` is finite); inf unless NaN appears exactly where ``want`` has
    it."""
    import torch

    got, want = got.float(), want.float()
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        return math.inf
    fin = torch.isfinite(want)
    if not fin.any():  # every row fully masked: NaN everywhere, as in the plain version
        return 0.0
    return ((got[fin] - want[fin]).abs() - K3_BF16_TOL * (1 + want[fin].abs())).max().item()


def fp32_err(got, want) -> float:
    """K3 fp32 against its plain version: the max |got - want| over finite
    ``want`` (0 where none is); inf unless NaN appears exactly where
    ``want`` has it."""
    import torch

    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        return math.inf
    fin = torch.isfinite(want)
    if not fin.any():  # every row fully masked: NaN everywhere, as in the plain version
        return 0.0
    return (got[fin] - want[fin]).abs().max().item()


def k3_bf16_checks(gen) -> dict:
    """K3's bf16 route: first one S tile and one P V tile alone at each head
    dim and key tile (the bring-up check of its tensor-map copies, swizzled
    image and fragment maps: exact bf16 products in fp32), then the four
    shapes at both batches on bf16 inputs against the plain version on the
    same inputs (the JAX dense path's rounding), timed beside SDPA in bf16
    (yardstick only); every plan of the sweep (keys per tile x rows per
    block x the persistent schedule or a block per row block) is timed and
    held to the tolerance too. Then a ragged batch (Tk not a multiple of the
    tile, B > 1) on both schedules, the masked case, and the registers and
    spills of each instance from nvcc's report of the library loaded."""
    import torch
    import torch.nn.functional as F

    from demucs_tpu_torch.kernels import _build
    from demucs_tpu_torch.kernels import attention as KA

    dev = torch.device("cuda")
    excess = bf16_excess
    tiles = {}
    for d, n in itertools.product(KA.HEAD_DIMS, (64, 128)):
        q = torch.randn(64, d, device=dev, generator=gen).bfloat16()
        k, v = (torch.randn(n, d, device=dev, generator=gen).bfloat16() for _ in range(2))
        p = torch.rand(64, n, device=dev, generator=gen)
        s_tile, o_tile = KA.bf16_tiles(q, k, v, p)
        want_s, want_o = q.double() @ k.double().T, p.bfloat16().double() @ v.double()
        tiles[f"d={d} keys={n}"] = {
            "S_err_over_peak": ((s_tile - want_s).abs().max() / want_s.abs().max()).item(),
            "PV_err_over_peak": ((o_tile - want_o).abs().max() / want_o.abs().max()).item()}
    tiles_ok = all(max(t.values()) <= 1e-5 for t in tiles.values())
    C, H = 512, 8
    d = C // H
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    tokens = {"freq": 2688, "time": 1344}
    by_shape, sweep, worst = {}, {}, -math.inf
    for batch in (1, 6):
        for tq_name, tk_name in (("freq", "freq"), ("time", "time"), ("freq", "time"),
                                 ("time", "freq")):
            Tq, Tk = tokens[tq_name], tokens[tk_name]
            q, k, v = (torch.randn(batch, T, C, device=dev, generator=gen).bfloat16()
                       for T in (Tq, Tk, Tk))
            want = KA.flash_mha_plain(q, k, v, H)
            got = KA.flash_mha(q, k, v, H)
            worst = max(worst, excess(got, want))
            split = [t.view(batch, -1, H, d).transpose(1, 2) for t in (q, k, v)]
            flops = 4 * batch * H * Tq * Tk * d
            b_ms, b_by = bound(flops, 2 * 2 * batch * (Tq + Tk) * C, BF16_FLOPS)
            key = f"B={batch} {tq_name}<-{tk_name}"
            rows, ctas = KA.bf16_plan(batch, Tq, Tk, H, sm)
            by_shape[key] = dict(max_abs_err=(got.float() - want.float()).abs().max().item(),
                                 ms=cuda_ms(lambda: KA.flash_mha(q, k, v, H)),
                                 sdpa_bf16_ms=cuda_ms(
                                     lambda: F.scaled_dot_product_attention(*split)),
                                 bound_ms=b_ms, bound_by=b_by,
                                 plan=f"{KA.KEY_TILE_BF16} keys, {rows} rows, {ctas} blocks")
            if key == "B=1 freq<-freq":
                by_shape[key]["plain_ms"] = cuda_ms(lambda: KA.flash_mha_plain(q, k, v, H))
            for bk, r, persistent in BF16_PLANS:
                with bf16_plan(KEY_TILE_BF16=bk, BF16_ROWS=r, BF16_PERSISTENT=persistent):
                    worst = max(worst, excess(KA.flash_mha(q, k, v, H), want))
                    sweep.setdefault(key, {})[
                        f"{bk} keys {r} rows {'persistent' if persistent else 'grid'}"] = cuda_ms(
                            lambda: KA.flash_mha(q, k, v, H))
            chosen = (f"{KA.KEY_TILE_BF16} keys {rows} rows "
                      f"{'grid' if ctas == -(-Tq // rows) * H * batch else 'persistent'}")
            by_shape[key]["chosen_over_fastest_in_sweep"] = (sweep[key][chosen]
                                                            / min(sweep[key].values()))
    # a ragged batch: Tk not a multiple of the tile, B > 1 (a box reading the
    # next item's keys would show), on both schedules
    q, k, v = (torch.randn(3, T, C, device=dev, generator=gen).bfloat16() for T in (200, 130, 130))
    want = KA.flash_mha_plain(q, k, v, H)
    ragged = {}
    for persistent in (False, True):
        with bf16_plan(BF16_PERSISTENT=persistent):
            ragged[f"persistent={persistent}"] = excess(KA.flash_mha(q, k, v, H), want)
    worst = max(worst, *ragged.values())
    q, k, v = (torch.randn(1, 2688, C, device=dev, generator=gen).bfloat16() for _ in range(3))
    mask = torch.ones(2688, 2688, dtype=torch.bool, device=dev)
    mask[:, :KA.KEY_TILE_BF16] = False  # the first key tile, fully masked for every row
    mask[7] = False
    got = KA.flash_mha(q, k, v, H, mask=mask).float()
    want = KA.flash_mha_plain(q, k, v, H, mask=mask).float()
    if not torch.equal(torch.isnan(got), torch.isnan(want)) or not torch.isnan(got[0, 7]).all():
        raise AssertionError("K3 bf16: masked rows do not give NaN where the plain version does")
    masked = excess(got, want)
    worst = max(worst, masked)
    main = by_shape["B=1 freq<-freq"]
    instances = bf16_instances()
    # per head dim up to 64: 4 plans x dropout or not x masked or not; at 128
    # one plan, dropout or not, masked or not
    wanted = (len(KA.HEAD_DIMS) - 1) * 4 * 2 * 2 + 4
    if len(instances) != wanted or not all(
            {"registers_at_launch", "spill_stores", "spill_loads"} <= set(v)
            for v in instances.values()):
        raise AssertionError(f"K3 bf16: nvcc's report lacks instances: {sorted(instances)}")
    return dict(
        name="flash_mha_bf16", tol=K3_BF16_TOL, tol_rule="atol = rtol = 2**-6",
        max_abs_err=max(r["max_abs_err"] for r in by_shape.values()),
        worst_excess_over_tol=worst, ragged_batch_excess=ragged, masked_excess=masked,
        within_tol=worst <= 0 and tiles_ok, tiles=tiles,
        source="demucs_tpu_torch/csrc/flash_mha.cu",
        replaces="demucs_tpu/ops/pallas/attention.py:103",
        ms=main["ms"], plain_ms=main["plain_ms"], library_ms=main["sdpa_bf16_ms"],
        library="F.scaled_dot_product_attention (bf16)",
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        bound_rule="max(4 B H Tq Tk d / 989 TFLOP/s (bf16 on the tensor cores), "
                   "bytes of q, k, v and o in bf16 moved once / 3.35 TB/s)",
        by_shape=by_shape, plan_sweep_ms=sweep, instances=instances,
        shape="q, k, v (1, 2688, 512) bf16, 8 heads (freq self)")


# K3's head dims off its first instances (32, 48, 64): each runs on the next
# instance up, padded; 128 is an instance of its own
HEAD_DIM_CHECKS = (16, 24, 40, 96, 128)
HEAD_DIM_HEADS = 4  # the released width's 512 channels in 4 heads: head dim 128


def _head_dim_case(gen, B: int, Tq: int, Tk: int, d: int, bf16: bool = False,
                   heads: int = HEAD_DIM_HEADS):
    import torch

    q, k, v = (torch.randn(B, T, heads * d, device="cuda", generator=gen) for T in (Tq, Tk, Tk))
    return tuple(t.bfloat16() for t in (q, k, v)) if bf16 else (q, k, v)


def _k3_against_plain(errs: dict, excess: dict, key: str, q, k, v, heads: int, mask,
                      bf16: bool) -> None:
    """One call of K3 through its wrapper against the plain version on the
    same inputs: errs[key] the max |kernel - plain| over the plain's finite
    values (inf where NaN differs), on bf16 also excess[key], the excess
    over K3_BF16_TOL."""
    from demucs_tpu_torch.kernels import attention as KA

    got, want = KA.flash_mha(q, k, v, heads, mask=mask), KA.flash_mha_plain(q, k, v, heads,
                                                                            mask=mask)
    errs[key] = fp32_err(got.float(), want.float())
    if bf16:
        excess[key] = bf16_excess(got, want)


def k3_head_dims_checks(gen) -> list:
    """K3 at head dims 16, 24, 40, 96 (padded to the next instance) and 128
    (its own instance) on both routes, unmasked and under a keep-mask whose
    first key tile and one row are fully masked, against the plain version
    at a ragged shape (fp32 K3_ATOL, bf16 2^-6 abs + rel, NaN only where the
    plain version has it), and d = 128 at one query over 70 keys (B = 3, one
    head; masked, the only row fully masked: NaN everywhere); then at freq
    self (Tq = Tk = 2688, 4 heads) at B = 1 and 6: the D = 128 instances
    (unmasked, and under the diag mask at the reference's defaults) against
    the plain version on the timed inputs, beside SDPA with the same mask
    and their bound (the function's least work at the true d: fp32 3 x 4 B
    H Tq Tk d over 495 TFLOP/s, bf16 4 B H Tq Tk d over 989; masked, the
    kept scores), and each padded head dim's time through the wrapper
    beside the kernel alone on inputs padded before (the pad and the crop's
    cost); the D = 128 instances' registers and spills (none may spill).
    Returns the four D = 128 rows of the kernels line, their errors those
    at freq self."""
    import torch
    import torch.nn.functional as F

    from demucs_tpu_torch.kernels import attention as KA
    from demucs_tpu_torch.ops.sparse import keep_mask

    H = HEAD_DIM_HEADS
    errs, excess = {}, {}  # max |kernel - plain| (finite), and bf16's excess over its tolerance
    for d in HEAD_DIM_CHECKS:
        for bf16 in (False, True):
            q, k, v = _head_dim_case(gen, 2, 333, 517, d, bf16)
            mask = torch.rand(333, 517, device="cuda", generator=gen) > 0.4
            mask[:, :64] = False
            mask[7] = False
            for m in (None, mask):
                key = f"{'bf16' if bf16 else 'fp32'} d={d}{'' if m is None else ' masked'}"
                _k3_against_plain(errs, excess, key, q, k, v, H, m, bf16)
    for bf16 in (False, True):  # one query row, ragged keys, one head
        q, k, v = _head_dim_case(gen, 3, 1, 70, 128, bf16, heads=1)
        mask = torch.rand(1, 70, device="cuda", generator=gen) > 0.6
        mask[0] = False
        for m in (None, mask):
            key = f"{'bf16' if bf16 else 'fp32'} d=128 3x1x70 H=1{'' if m is None else ' masked'}"
            _k3_against_plain(errs, excess, key, q, k, v, 1, m, bf16)
    timed, rows = {}, []
    diag = keep_mask(2688, 2688, "diag", device="cuda", **MASK_DEFAULTS)
    kept = int(diag.bool().sum().item())
    for batch in (1, 6):
        for d in HEAD_DIM_CHECKS:
            for bf16 in (False, True):
                route = "bf16" if bf16 else "fp32"
                q, k, v = _head_dim_case(gen, batch, 2688, 2688, d, bf16)
                key = f"{route} d={d} B={batch}"
                timed[key] = {"ms": cuda_ms(lambda: KA.flash_mha(q, k, v, H))}
                if d != 128:  # the kernel alone, on inputs padded before
                    padded = [KA.pad_heads(t, H, KA.instance_dim(d)) for t in (q, k, v)]
                    launch = KA._forward_bf16 if bf16 else KA._forward_f32
                    timed[key]["kernel_ms"] = cuda_ms(
                        lambda: launch(*padded, H, None, 0.0, 0, False, d))
                    timed[key]["pad_crop_ms"] = timed[key]["ms"] - timed[key]["kernel_ms"]
                    continue
                split = [t.view(batch, -1, H, d).transpose(1, 2) for t in (q, k, v)]
                size = 2 if bf16 else 4
                for m in (None, diag):
                    scores = 2688 * 2688 if m is None else kept
                    flops = 4 * batch * H * scores * d
                    nbytes = size * 2 * batch * 2 * 2688 * H * d + (0 if m is None else
                                                                    2688 * 2688 // 8)
                    b_ms, b_by = (bound(flops, nbytes, BF16_FLOPS) if bf16
                                  else bound(3 * flops, nbytes, TF32_FLOPS))
                    keep = None if m is None else m.bool()
                    case = dict(
                        ms=cuda_ms(lambda: KA.flash_mha(q, k, v, H, mask=m)),
                        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                            *split, attn_mask=keep)),
                        bound_ms=b_ms, bound_by=b_by)
                    case["bound_share"] = case["bound_ms"] / case["ms"]
                    if batch == 1:
                        case["plain_ms"] = cuda_ms(lambda: KA.flash_mha_plain(q, k, v, H, mask=m))
                    name = key + ("" if m is None else " diag")
                    _k3_against_plain(errs, excess, f"{name} freq self", q, k, v, H, m, bf16)
                    timed[name] = case
                del split
            torch.cuda.empty_cache()
    f_inst, b_inst = f32_instances(), bf16_instances()
    inst = {**{f"fp32 {k}": v for k, v in f_inst.items() if k.startswith("d=128")},
            **{f"bf16 {k}": v for k, v in b_inst.items() if k.startswith("d=128")}}
    spills = [k for k, v in inst.items() if v.get("spill_stores") or v.get("spill_loads")]
    if len(inst) != 6 or spills:  # fp32 masked or not; bf16 also with the dropout
        raise AssertionError(f"K3 D = 128: instances {sorted(inst)}, spilling {spills}")
    for bf16 in (False, True):
        route = "bf16" if bf16 else "fp32"
        for masked in (False, True):
            suffix = " diag" if masked else ""
            b1, b6 = timed[f"{route} d=128 B=1{suffix}"], timed[f"{route} d=128 B=6{suffix}"]
            name = ("flash_mha_bf16" if bf16 else "flash_mha") + " D=128" + (
                " masked" if masked else "")
            # the row's shape, both batches: the timed calls' outputs against the plain version
            mine = [f"{route} d=128 B={batch}{suffix} freq self" for batch in (1, 6)]
            worst = max(errs[k] for k in mine)
            rows.append(dict(
                name=name, source="demucs_tpu_torch/csrc/flash_mha_d128.cu",
                replaces="demucs_tpu/ops/pallas/attention.py:103",
                ms=b1["ms"], plain_ms=b1["plain_ms"], library_ms=b1["library_ms"],
                library=f"F.scaled_dot_product_attention ({'bf16' if bf16 else 'fp32'}"
                        f"{', same mask' if masked else ''})",
                bound_ms=b1["bound_ms"], bound_by=b1["bound_by"], batch_6=b6,
                max_abs_err=worst, tol=K3_BF16_TOL if bf16 else K3_ATOL,
                within_tol=(max(excess[k] for k in mine) <= 0) if bf16 else worst <= K3_ATOL,
                checked=mine,
                shape=f"q, k, v (1, 2688, 512), 4 heads of 128 (freq self; also B = 6)"
                      f"{', diag mask' if masked else ''}"))
    bad = {k: v for k, v in errs.items() if not (excess[k] <= 0 if k in excess else v <= K3_ATOL)}
    emit({"phase": "head_dim_kernels", "card": card_line(), "max_abs_err": errs,
          "bf16_excess_over_tol": excess, "times": timed,
          "instances": inst, "fp32_tol": K3_ATOL, "bf16_tol": K3_BF16_TOL,
          "ok": not bad})
    if bad:
        raise AssertionError(f"K3 at head dims off its instances disagrees: {bad}")
    return rows


def card_vs_cpu(cpu_model, seconds: float, seed: int = 1) -> dict:
    """One forward of ``seconds`` of noise on a copy on the card and on the CPU."""
    import torch

    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    mix = torch.randn(1, 2, int(seconds * SR), generator=torch.Generator().manual_seed(seed))
    with torch.inference_mode():
        got = gpu_model(mix.to("cuda") * 0.1).cpu()
        start = time.perf_counter()
        want = cpu_model(mix * 0.1)
        cpu_s = time.perf_counter() - start
    del gpu_model
    peak = want.abs().max().item()
    rel = (got - want).abs().max().item() / peak
    return {"seconds": seconds, "max_abs_err_over_peak": rel, "tol": MODEL_RTOL, "peak": peak,
            "cpu_forward_s": cpu_s,
            "ok": bool(torch.isfinite(got).all()) and got.shape == want.shape
            and rel <= MODEL_RTOL}


def serve_both_engines(sep, counts, lengths, seed: int, repeats: int = FAMILY_REPEATS) -> dict:
    """Each request length ``repeats`` times on each engine (after a warm-up
    request of each, which captures every graph of the full windows):
    audio-s/s, peak memory, launches against the forwards, and the device
    engine's stems against the host engine's for the same shift."""
    import random

    import numpy as np
    import torch

    tracks = [_track(seconds, seed + i) for i, seconds in enumerate(lengths)]
    for engine in ("host", "auto"):
        sep.update_parameter(engine=engine)
        for wav in tracks:
            sep.separate_tensor(wav, SR)
    info: dict = {"engines": {}}
    last = {}
    for name, engine in (("device", "auto"), ("host", "host")):
        sep.update_parameter(engine=engine)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts.zero()
        requests = []
        for i, (seconds, wav) in enumerate(zip(lengths, tracks)):
            walls = []
            for r in range(repeats):
                random.seed(100 * i + r)  # the same shift on both engines
                start = time.perf_counter()
                _, stems = sep.separate_tensor(wav, SR)
                walls.append(time.perf_counter() - start)
                if any(v.shape != wav.shape or not np.isfinite(v).all() for v in stems.values()):
                    raise AssertionError(f"{name} {seconds} s: stems not finite or misshaped")
            last[name, i] = np.stack(list(stems.values()))
            wall = float(np.median(walls))
            requests.append({"seconds": seconds, "repeats": repeats, "median_wall_s": wall,
                             "wall_s": walls, "audio_s_per_s": seconds / wall})
        run = counts.read()
        run.update(requests=requests,
                   max_memory_allocated_GiB=torch.cuda.max_memory_allocated() / 2**30)
        info["engines"][name] = run
    agree = []
    for i, seconds in enumerate(lengths):
        peak = float(np.abs(last["host", i]).max())
        err = float(np.abs(last["device", i] - last["host", i]).max()) / peak
        agree.append({"seconds": seconds, "max_abs_err_over_peak": err, "tol": ENGINE_RTOL})
    info["device_vs_host"] = agree
    info["ok"] = (all(run["ok"] for run in info["engines"].values())
                  and all(a["max_abs_err_over_peak"] <= ENGINE_RTOL for a in agree))
    sep.update_parameter(engine="auto")
    return info


def phase_model():
    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs

    cfg = HTDemucsConfig(segment=1.0, **RELEASED)
    cpu_model = init_htdemucs(cfg, seed=0, layer_scale=1.0, random_norms=True).eval()
    info = dict(card_vs_cpu(cpu_model, 1.0), phase="model",
                params_M=sum(p.numel() for p in cpu_model.parameters()) / 1e6)
    emit(info)
    if not info["ok"]:
        raise AssertionError(f"card vs CPU forward: {info}")
    return cpu_model


def _track(seconds: float, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    tones = sum(a * np.sin(2 * np.pi * f * t + p)
                for a, f, p in [(0.3, 110.0, 0.0), (0.2, 440.0, 1.0), (0.1, 2637.0, 2.0)])
    noise = rng.standard_normal((2, t.size)) * 0.05
    return (np.stack([tones, 0.8 * tones]) + noise).astype(np.float32)


def _bf16_attention(module) -> bool:
    """Whether the module's attention takes K3's bf16 route (a bf16 transformer stage)."""
    from demucs_tpu_torch.models.htdemucs import _bf16_stage_set

    return hasattr(module.cfg, "bf16_stages") and "transformer" in _bf16_stage_set(module.cfg)


def k3_per_forward(cfg) -> int:
    """K3's launches in one forward: one per attention of each branch (2 x
    ``t_layers``), less the LSH layers', which take the dense route."""
    layers = getattr(cfg, "t_layers", 0)
    if not (getattr(cfg, "t_auto_sparsity", False) and cfg.t_sparsity):
        return 2 * layers
    parity = 1 if cfg.t_cross_first else 0
    return sum(0 if (cfg.t_sparse_self_attn if idx % 2 == parity else cfg.t_sparse_cross_attn)
               else 2 for idx in range(layers))


class Counts:
    """The kernels' launches on one path: the wrappers' counts (eager launches)
    plus each graph replay's captured launches, both zeroed by ``zero()``;
    and the batched forwards of each module: eager ones (a forward hook) plus
    replays (recorded around ``GRAPHS.forward``). What a forward launches
    follows from its module's config: K1 and K2 once if it has a spectrogram
    (``nfft``: not Demucs v2), K3 once per attention, 2 branches x
    ``t_layers`` (10 at the released HTDemucs width, 0 without a
    transformer) less the LSH layers (``k3_per_forward``), on its bf16 route
    where the transformer stage is bf16.
    The counted run must capture nothing: a capture calls the module twice
    and launches once."""

    def __init__(self, *modules):
        from demucs_tpu_torch.inference.engine import GRAPHS

        self.eager: list = []
        self.replayed: list = []
        for module in modules:
            module.register_forward_pre_hook(lambda mod, args: self.eager.append(mod))
        forward = GRAPHS.forward

        def recorded(module, batch):
            self.replayed.append(module)
            return forward(module, batch)

        GRAPHS.forward = recorded

    def zero(self) -> None:
        from demucs_tpu_torch.inference.engine import GRAPHS

        zero_launches()
        GRAPHS.reset_counts()
        self.eager.clear()
        self.replayed.clear()

    def read(self) -> dict:
        from demucs_tpu_torch.inference.engine import GRAPHS, _launch_counts

        # each wrapper's and each K3 instance's ("flash_mha D=128 masked")
        launches = {name: n + GRAPHS.replayed_launches.get(name, 0)
                    for name, n in _launch_counts().items()}
        forwards = self.eager + self.replayed
        k12 = sum(hasattr(m.cfg, "nfft") for m in forwards)
        attn = [(k3_per_forward(m.cfg), _bf16_attention(m)) for m in forwards]
        want = {"stft_dft": k12, "istft_dft": k12,
                "flash_mha": sum(n for n, bf16 in attn if not bf16),
                "flash_mha_bf16": sum(n for n, bf16 in attn if bf16)}
        return {"launches": launches, "expected": want, "eager_forwards": len(self.eager),
                "graph_replays": len(self.replayed),
                "replayed_launches": dict(GRAPHS.replayed_launches),
                "ok": {k: launches[k] for k in want} == want and bool(forwards)
                and len(self.replayed) == GRAPHS.replays}


def zero_launches() -> None:
    """Every forward kernel wrapper's launch count at 0, K3's per instance too."""
    from demucs_tpu_torch.inference.engine import KERNELS

    for kernel in KERNELS:
        kernel.launches = 0
        for key in getattr(kernel, "launches_by_instance", {}):
            kernel.launches_by_instance[key] = 0


def phase_serving(cpu_model, workdir: Path) -> dict:
    """The three requests on each engine: the device engine (Separator's
    default) and the host engine; each device-engine request's stems against
    the host engine's for the same shift."""
    from demucs_tpu_torch.api import Separator
    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig
    from demucs_tpu_torch.models.registry import Model
    from demucs_tpu_torch.zoo.native import save_model

    cfg = HTDemucsConfig(segment=7.8, **RELEASED)
    module = copy.deepcopy(cpu_model)
    module.cfg = cfg
    save_model(Model("htdemucs", cfg, module), workdir / "htdemucs_smoke.dmx", half=False)
    sep = Separator("htdemucs_smoke", repo=workdir, shifts=1, overlap=0.25, batch_size=16)
    info = dict(serve_both_engines(sep, Counts(sep.model.module), (30.0, 12.0, 5.0), seed=0,
                                   repeats=REPEATS), phase="serving")
    dev_run = info["engines"]["device"]
    info["forwards"] = dev_run["graph_replays"]
    # the default serving path: every forward a graph replay
    info["ok"] = (info["ok"] and dev_run["eager_forwards"] == 0
                  and dev_run["graph_replays"] >= 3 * REPEATS)
    emit(info)
    if not info["ok"]:
        raise AssertionError(f"serving: launches, engines or graphs wrong: {info}")
    sep.update_parameter(engine="host")
    info["batched_check"] = check_batched_forward(sep)
    sep.update_parameter(engine="auto")
    return info, sep


def phase_graphs(sep) -> dict:
    """The graphs serving captured (30, 12 and 5 s requests: batches of 6, 3
    and 1): count, capture time and pool, and a replay at B = 6 and B = 1
    against an eager forward of the same module on a fresh input."""
    import torch

    from demucs_tpu_torch.inference.engine import GRAPHS

    module = sep.model.module
    target = int(sep.model.segment * SR)
    checks = {}
    gen = torch.Generator(device="cuda").manual_seed(5)
    for batch in (6, 1):
        mix = torch.randn(batch, 2, target, device="cuda", generator=gen) * 0.1
        captures = GRAPHS.captures
        with torch.inference_mode():
            got = GRAPHS.forward(module, mix).clone()
            want = module(mix)
        peak = want.abs().max().item()
        checks[f"B={batch}"] = {
            "bit_equal": bool(torch.equal(got, want)), "tol": GRAPH_RTOL,
            "max_abs_err_over_peak": (got - want).abs().max().item() / peak,
            "captured_now": GRAPHS.captures != captures}
    info = dict(GRAPHS.stats(), phase="graphs", replay_vs_eager=checks)
    info["pool_GiB"] = (info["pool_bytes"] / 2**30 if info["pool_bytes"] is not None
                        else "not measured")
    info["ok"] = all(c["max_abs_err_over_peak"] <= GRAPH_RTOL and not c["captured_now"]
                     for c in checks.values())
    emit(info)
    if not info["ok"]:
        raise AssertionError(f"graph replay vs eager: {checks}")
    return info


def phase_bag() -> dict:
    """A bag of 4 released-width members of distinct random weights, with
    htdemucs_ft's one-hot weights, on a 30 s track with shifts=2: the device
    engine (apply_model's default on the card) against the host engine."""
    import random

    import numpy as np
    import torch

    from demucs_tpu_torch.inference.apply import apply_model
    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs
    from demucs_tpu_torch.models.registry import BagOfModels, Model

    cfg = HTDemucsConfig(segment=7.8, **RELEASED)
    members = [Model("htdemucs", cfg, init_htdemucs(cfg, seed=10 + k, layer_scale=1.0,
                                                    random_norms=True).eval().cuda())
               for k in range(4)]
    weights = np.eye(4).tolist()
    bag = BagOfModels(members, weights)
    mix = _track(30.0, 40)[None]
    counts = Counts(*(m.module for m in members))
    info = {"phase": "bag", "members": 4, "shifts": 2, "seconds": 30.0, "weights": weights}
    out = {}
    for name, engine in (("device", "auto"), ("host", "host")):
        apply_model(bag, mix, shifts=2, engine=engine, rng=random.Random(7))  # warm-up
        torch.cuda.synchronize()
        counts.zero()
        start = time.perf_counter()
        out[name] = apply_model(bag, mix, shifts=2, engine=engine, rng=random.Random(7))
        wall = time.perf_counter() - start
        info[name] = dict(counts.read(), wall_s=wall, audio_s_per_s=30.0 / wall)
    peak = float(np.abs(out["host"]).max())
    info["max_abs_err_over_peak"] = float(np.abs(out["device"] - out["host"]).max()) / peak
    info["tol"] = ENGINE_RTOL
    info["ok"] = (info["max_abs_err_over_peak"] <= ENGINE_RTOL and info["device"]["ok"]
                  and info["host"]["ok"] and info["device"]["eager_forwards"] == 0
                  and bool(np.isfinite(out["device"]).all()))
    emit(info)
    if not info["ok"]:
        raise AssertionError(f"bag on the device engine vs the host engine: {info}")
    return info


def phase_pipelined(sep) -> dict:
    """Three tracks through apply_model_tracks (each track's copy to the host
    overlapping the next one's compute), against one call per track with the
    same random.Random: bit-equal."""
    import random

    import numpy as np

    from demucs_tpu_torch.inference.apply import apply_model, apply_model_tracks

    tracks = [_track(seconds, 50 + i)[None] for i, seconds in enumerate((30.0, 12.0, 30.0))]
    rng = random.Random(11)
    start = time.perf_counter()
    single = [apply_model(sep.model, t, rng=rng) for t in tracks]
    single_s = time.perf_counter() - start
    start = time.perf_counter()
    piped = list(apply_model_tracks(sep.model, tracks, rng=random.Random(11)))
    piped_s = time.perf_counter() - start
    equal = [bool(np.array_equal(p, s)) for p, s in zip(piped, single)]
    info = {"phase": "pipelined", "tracks_s": [30.0, 12.0, 30.0], "bit_equal": equal,
            "single_calls_s": single_s, "pipelined_s": piped_s,
            "ok": len(piped) == 3 and all(equal)}
    emit(info)
    if not info["ok"]:
        raise AssertionError(f"pipelined tracks differ from single calls: {equal}")
    return info


def phase_wire(sep) -> dict:
    """The reduced-precision wires against the bit-exact one, on one 30 s
    request with the same shift."""
    import random

    import numpy as np

    wav = _track(30.0, 60)
    stems = {}
    for wire in (None, "int16", "float16"):
        sep.update_parameter(transfer_dtype=wire)
        random.seed(3)
        _, out = sep.separate_tensor(wav, SR)
        stems[wire] = np.stack(list(out.values()))
    sep.update_parameter(transfer_dtype=None)
    exact = stems[None]
    mean = wav.mean(axis=0).mean()  # Separator adds it back to the stems: the grid is of y * std
    step = np.abs(exact - mean).max(axis=-1, keepdims=True) / 32766.0
    info = {"phase": "wire", "seconds": 30.0}
    for wire in ("int16", "float16"):
        err = np.abs(stems[wire] - exact)
        info[wire] = {"max_err_in_int16_steps": float((err / step).max()),
                      "max_abs_err_over_peak": float(err.max() / np.abs(exact).max())}
    # half a step, plus float32 rounding of the decode and of the rescale by
    # std: 2**-24 of a sample is 32766 x 2**-24 = 0.002 steps at the peak
    info["ok"] = info["int16"]["max_err_in_int16_steps"] <= 0.51
    emit(info)
    if not info["ok"]:
        raise AssertionError(f"int16 wire beyond half a step of the float32 wire: {info}")
    return info


def check_batched_forward(sep) -> dict:
    """One more 30 s request: its batched forward (6 segments, so K1 sees 12
    rows, K2 48 and K3 a batch of 6) against a CPU copy of the served model."""
    import torch

    seen = []
    handle = sep.model.module.register_forward_hook(
        lambda mod, args, out: seen.append((args[0].cpu(), out.cpu())))
    try:
        sep.separate_tensor(_track(30.0, 0), SR)
    finally:
        handle.remove()
    mix, got = seen[0]
    cpu_module = copy.deepcopy(sep.model.module).to("cpu")
    start = time.perf_counter()
    with torch.inference_mode():
        want = cpu_module(mix)
    peak = want.abs().max().item()
    rel = (got - want).abs().max().item() / peak
    info = {"phase": "batched_check", "segments": mix.shape[0], "forwards": len(seen),
            "max_abs_err_over_peak": rel, "tol": MODEL_RTOL, "peak": peak,
            "cpu_forward_s": time.perf_counter() - start,
            "ok": mix.shape[0] == 6 and bool(torch.isfinite(got).all()) and rel <= MODEL_RTOL}
    emit(info)
    if not info["ok"]:
        raise AssertionError(f"batched forward on the card vs CPU: {info}")
    return info


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "memcpy dtoh" in low:
        return "copy device->host"
    if "memcpy htod" in low:
        return "copy host->device"
    if "istft_fft_kernel" in low:
        return "K2 istft_dft"
    if "stft_fft_kernel" in low:
        return "K1 stft_dft"
    if "flash_mha_bf16" in low:  # the kernel and its key-run merge
        return "K3 flash_mha_bf16"
    if "flash_mha_kernel" in low or "kv_image_kernel" in low:
        return "K3 flash_mha"
    if any(w in low for w in ("bwd_kernel", "bwd_prep_kernel", "bwd_dq_bf16_kernel",
                              "bwd_dq_f32_kernel")):  # K3's backward: the pass, its prep, dQ out
        return "K3 flash_mha_bwd"
    if "adam" in low or "multi_tensor" in low:  # the optimizer's fused updates
        return "optimizer (Adam)"
    if any(w in low for w in ("rnn", "lstm")):  # cuDNN's LSTM cells and recurrence
        return "cuDNN RNN (BLSTM)"
    if any(w in low for w in ("conv", "cudnn", "fprop", "dgrad", "winograd", "implicit")):
        return "convolutions (cuDNN)"
    if any(w in low for w in ("gemm", "cutlass", "cublas")):
        return "matmuls (cuBLAS)"
    if "norm" in low or "moments" in low:  # GroupNorm statistics: RowwiseMomentsCUDAKernel
        return "normalizations"
    if any(w in low for w in ("topk", "sort", "radix")):  # the LSH masks' top-k
        return "top-k (LSH masks)"
    return "other (elementwise, copies, reductions)"


def profile_request(sep, wav) -> dict:
    """One request under torch.profiler (after one unprofiled): device time
    by kernel group, the top kernels, and the device's busy share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sep.separate_tensor(wav, SR)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        sep.separate_tensor(wav, SR)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    groups: dict = {}
    top = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        if us <= 0:
            continue
        key = _kernel_group(evt.key)
        groups[key] = groups.get(key, 0.0) + us / 1e3
        top.append((us / 1e3, evt.count, evt.key[:90]))
    device_ms = sum(groups.values())
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "busy_share": device_ms / (wall * 1e3) if device_ms else "not measured",
            "idle_share": 1 - device_ms / (wall * 1e3) if device_ms else "not measured",
            "d2h_copy_ms": groups.get("copy device->host", "not measured"),
            "by_group_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"ms": ms, "calls": n, "name": key}
                            for ms, n, key in sorted(top, reverse=True)[:12]]}


def phase_profile(sep) -> dict:
    """One 30 s and one 5 s request per engine under torch.profiler: device
    time by kernel group (the stems' copy to the host its own group) and the
    device's busy share of the request's wall time."""
    info = {"phase": "profile"}
    for (name, engine), seconds in itertools.product((("device", "auto"), ("host", "host")),
                                                     (30.0, 5.0)):
        sep.update_parameter(engine=engine)
        info[f"{name} {seconds:.0f} s"] = profile_request(sep, _track(seconds, 0))
    sep.update_parameter(engine="auto")
    emit(info)
    return info


def family_model(kind: str, seed: int, **kw):
    """A released-width HDemucs (hdemucs_mmi's shape) or Demucs v2 at the
    bags' 44 s segment, seeded random weights (the JAX package's numbers for
    the seed), every LayerScale at 1.0 and random norms, on the CPU."""
    from demucs_tpu_torch.models import demucs as D
    from demucs_tpu_torch.models import hdemucs as H

    if kind == "hdemucs":
        cfg = H.HDemucsConfig(**dict(HDEMUCS, segment=44.0, **kw))
        return H.init_hdemucs(cfg, seed, layer_scale=1.0, random_norms=True).eval()
    cfg = D.DemucsConfig(**dict(DEMUCS, segment=44.0, **kw))
    return D.init_demucs(cfg, seed, layer_scale=1.0, random_norms=True).eval()


def phase_family(kind: str, workdir: Path) -> dict:
    """HDemucs (``kind="hdemucs"``, hdemucs_mmi's shape) or Demucs v2 on the
    card: the forward against a CPU copy (2 s), then a Separator loaded from
    a .dmx answering a 30 s and a 60 s request on each engine (the 44 s
    segment: 30 s is one exact tail, eager; 60 s one graph replay of 2 full
    windows plus an eager tail), graphs, and one profiled 60 s request on
    the device engine."""
    import torch

    from demucs_tpu_torch.api import Separator
    from demucs_tpu_torch.inference.engine import GRAPHS
    from demucs_tpu_torch.models.registry import Model
    from demucs_tpu_torch.zoo.native import save_model

    torch.cuda.reset_peak_memory_stats()
    cpu_model = family_model(kind, seed=0)
    info = {"phase": "demucs_v2" if kind == "demucs" else kind,
            "params_M": sum(p.numel() for p in cpu_model.parameters()) / 1e6,
            "card_vs_cpu": card_vs_cpu(cpu_model, 2.0)}
    name = f"{kind}_smoke"
    save_model(Model(kind, cpu_model.cfg, cpu_model), workdir / f"{name}.dmx", half=False)
    del cpu_model
    sep = Separator(name, repo=workdir, shifts=1, overlap=0.25, batch_size=16)
    counts = Counts(sep.model.module)
    before = GRAPHS.stats()
    info["serving"] = serve_both_engines(sep, counts, FAMILY_LENGTHS, seed=70)
    after = GRAPHS.stats()
    info["graphs"] = {"captured_here": after["captures"] - before["captures"],
                      "capture_s": after["capture_s"] - before["capture_s"],
                      "warmup_s": after["warmup_s"] - before["warmup_s"],
                      "device_engine_replays": info["serving"]["engines"]["device"][
                          "graph_replays"],
                      "device_engine_eager_forwards": info["serving"]["engines"]["device"][
                          "eager_forwards"],
                      "eager": "every exact tail (its own length); full windows replay",
                      "stats": after}
    sep.update_parameter(engine="auto")
    info["profile"] = {"device 60 s": profile_request(sep, _track(60.0, 0))}
    info["max_memory_allocated_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    dev_run = info["serving"]["engines"]["device"]
    info["ok"] = (info["card_vs_cpu"]["ok"] and info["serving"]["ok"]
                  and dev_run["graph_replays"] > 0 and dev_run["eager_forwards"] > 0)
    emit(info)
    if not info["ok"]:
        raise AssertionError(f"{kind}: card, engines, launches or graphs wrong")
    del sep
    torch.cuda.empty_cache()
    return info


def phase_wiener() -> dict:
    """apply_wiener (1 EM iteration) on the card against the CPU, at one 44 s
    segment's spectrogram (2048 bins x 1895 frames, 4 sources); and the
    MDX-era HDemucs (hybrid_old, cac=False: magnitudes through Wiener) with
    one iteration, card against CPU on 2 s."""
    import torch

    from demucs_tpu_torch.models.htdemucs import precision_scope
    from demucs_tpu_torch.ops.wiener import apply_wiener

    gen = torch.Generator().manual_seed(4)
    mags = torch.rand(1, 4, 2, 2048, 1895, generator=gen) * 10
    z = torch.complex(torch.randn(1, 2, 2048, 1895, generator=gen),
                      torch.randn(1, 2, 2048, 1895, generator=gen)) * 10
    with precision_scope(None):
        want = apply_wiener(mags, z, 1)
        got = apply_wiener(mags.cuda(), z.cuda(), 1)
        ms = cuda_ms(lambda: apply_wiener(mags.cuda(), z.cuda(), 1), repeat=3, spin=False)
    rel = (got.cpu() - want).abs().max().item() / want.abs().max().item()
    info = {"phase": "wiener", "shape": "mags (1, 4, 2, 2048, 1895)", "iterations": 1,
            "max_abs_err_over_peak": rel, "tol": ENGINE_RTOL, "card_ms": ms,
            "cac_false_hdemucs": card_vs_cpu(family_model("hdemucs", 1, **MDX_HYBRID,
                                                          wiener_iters=1), 2.0)}
    info["ok"] = rel <= ENGINE_RTOL and info["cac_false_hdemucs"]["ok"]
    emit(info)
    if not info["ok"]:
        raise AssertionError(f"wiener on the card vs the CPU: {info}")
    return info


def write_th(folder: Path, sig: str, kind: str, cfg, state: dict) -> Path:
    """``<folder>/<sig>-<sha256[:8]>.th`` in the reference's format
    (``demucs/states.py:121-132``): ``torch.save`` of ``{klass, args, kwargs,
    state, training_args}``, the model class pickled by name from a stub
    ``demucs.<family>`` module that exists only while the file is written."""
    import hashlib
    import io
    import types

    import torch

    module_name, class_name = {"hdemucs": ("demucs.hdemucs", "HDemucs"),
                               "demucs": ("demucs.demucs", "Demucs")}[kind]
    stub = types.ModuleType(module_name)
    klass = type(class_name, (), {"__module__": module_name})
    setattr(stub, class_name, klass)
    added = [name for name in ("demucs", module_name) if name not in sys.modules]
    sys.modules.setdefault("demucs", types.ModuleType("demucs"))
    sys.modules[module_name] = stub
    kwargs = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "sources"}
    try:
        buf = io.BytesIO()
        torch.save({"klass": klass, "args": (list(cfg.sources),), "kwargs": kwargs,
                    "state": state, "training_args": {}}, buf)
    finally:
        for name in added:
            sys.modules.pop(name, None)
    data = buf.getvalue()
    path = folder / f"{sig}-{hashlib.sha256(data).hexdigest()[:8]}.th"
    path.write_bytes(data)
    return path


def diffq_state(flat: dict, order, min_size_mb: float = 0.2, group: int = 8):
    """A diffq container (``docs/diffq_format.md``) of ``flat``: parameters of
    more than ``min_size_mb`` MB as 8-bit levels over each group's [min, max]
    (uint8 levels, float32 (G, 2) scales, bits per group), in ``order``, the
    others as float32; and the weights a reader must decode from it."""
    import numpy as np
    import torch

    quantized, others, decoded = [], [], {}
    for name, shape in order:
        arr = flat[name].astype(np.float32)
        if arr.size <= int(min_size_mb * 2**20) // 4:
            others.append(torch.from_numpy(arr))
            decoded[name] = arr
            continue
        g = arr.reshape(-1, group)
        mn, mx = g.min(-1, keepdims=True), g.max(-1, keepdims=True)
        span = np.where(mx > mn, mx - mn, 1.0)
        levels = np.round((g - mn) / span * 255.0).astype(np.uint8)
        scales = np.concatenate([mn, mx], axis=-1).astype(np.float32)
        bits = np.full(g.shape[0], 8, np.uint8)
        quantized.append((torch.from_numpy(levels), torch.from_numpy(scales),
                          torch.from_numpy(bits)))
        lo, hi = scales[:, :1].astype(np.float64), scales[:, 1:].astype(np.float64)
        decoded[name] = (levels / 255.0 * (hi - lo) + lo).astype(np.float32).reshape(shape)
    state = {"__quantized": True, "quantized": quantized, "others": others, "float16": [],
             "meta": {"klass": "DiffQuantizer",
                      "init_kwargs": {"min_size": min_size_mb, "group_size": group}}}
    return state, decoded


def phase_zoo(workdir: Path) -> tuple:
    """A folder in the reference's formats, with the shape of repro_mdx_a
    (repo.py:83): two Demucs v2 and two MDX-era HDemucs (hybrid_old, cac=False:
    Wiener on the path) as .th packages of fp16 weights, the last one
    diffq-quantized, and a bag file with segment 44. Separator(model=<bag>,
    repo=folder) on the card: the weights equal the written ones (fp16
    promoted to fp32, the quantized ones decoded), and a 30 s request gives the
    same stems on both engines."""
    import numpy as np
    import torch

    from demucs_tpu_torch.api import Separator
    from demucs_tpu_torch.zoo.convert import flat_state
    from demucs_tpu_torch.zoo.diffq import param_order

    folder = workdir / "zoo"
    folder.mkdir()
    sigs, expected = [], []
    members = [("demucs", {}), ("demucs", {}), ("hdemucs", MDX_HYBRID), ("hdemucs", MDX_HYBRID)]
    for i, (kind, kw) in enumerate(members):
        model = family_model(kind, 20 + i, **kw)
        cfg = dataclasses.replace(model.cfg, segment=40.0)
        flat = flat_state(model)
        del model
        if i == len(members) - 1:
            state, decoded = diffq_state(flat, param_order(kind, cfg))
        else:
            state = {k: torch.from_numpy(v).half() for k, v in flat.items()}
            decoded = {k: v.astype(np.float16).astype(np.float32) for k, v in flat.items()}
        sigs.append(f"{i:02d}{kind[:6]}")
        write_th(folder, sigs[-1], kind, cfg, state)
        expected.append(decoded)
    bag = "repro_mdx_a_smoke"
    (folder / f"{bag}.yaml").write_text(f"models: {sigs}\nsegment: 44\n")
    start = time.perf_counter()
    sep = Separator(bag, repo=folder, shifts=1, batch_size=16)
    load_s = time.perf_counter() - start
    members_ok = []
    for model, want in zip(sep.model.models, expected):
        state = {k: v.cpu().numpy() for k, v in model.module.state_dict().items()}
        members_ok.append(set(state) == set(want) and all(
            state[k].dtype == np.float32 and np.array_equal(state[k], want[k]) for k in want))
    counts = Counts(*(m.module for m in sep.model.models))
    serving = serve_both_engines(sep, counts, (30.0,), seed=90, repeats=1)
    info = {"phase": "zoo", "files": sorted(p.name for p in folder.iterdir()), "load_s": load_s,
            "kinds": [m.kind for m in sep.model.models],
            "segments": [m.segment for m in sep.model.models],
            "weights_equal_written": members_ok, "serving": serving}
    info["ok"] = (all(members_ok) and serving["ok"] and info["segments"] == [44.0] * 4
                  and info["kinds"] == ["demucs", "demucs", "hdemucs", "hdemucs"])
    emit(info)
    if not info["ok"]:
        raise AssertionError(f"zoo: loading or serving the bag failed: {info}")
    return info, folder, bag


def _stems(sep, wav, seed: int = 7):
    """One request's stems as an array, the shift drawn after ``random.seed(seed)``."""
    import random

    import numpy as np

    random.seed(seed)
    return np.stack(list(sep.separate_tensor(wav, SR)[1].values()))


def _ser_db(ref, out):
    """Signal-to-error ratio in dB, or "bit-equal"."""
    import numpy as np

    err = float(np.sum((ref.astype(np.float64) - out) ** 2))
    return "bit-equal" if err == 0 else 10 * math.log10(float(np.sum(ref.astype(np.float64) ** 2))
                                                         / err)


def phase_engines(workdir: Path, zoo: Path, bag: str) -> dict:
    """C1: the device and host engines past one segment. HDemucs and Demucs v2
    at 60 s (one full 44 s window, then an eager tail) and the
    repro_mdx_a-shape bag at 30 s, with a pinned shift offset:

    - as served (batch_size 16): the device engine replays the full window in
      a graph of 2 (one slot empty), the host engine runs it alone;
    - each engine twice: is each deterministic?
    - the same composition (batch_size 1: every forward one window, graph or
      eager) under cudnn.deterministic=True and benchmark=False;
    - one full window's forward eager at B = 1, eager at B = 2 (beside a zero
      window) and replayed from a graph at B = 2: the batch shape's effect."""
    import numpy as np
    import torch

    from demucs_tpu_torch.api import Separator
    from demucs_tpu_torch.inference.engine import GRAPHS

    info = {"phase": "engines", "shift_offsets": [2500]}
    cases = (("hdemucs", "hdemucs_smoke", workdir, 60.0),
             ("demucs_v2", "demucs_smoke", workdir, 60.0),
             ("repro_mdx_a bag", bag, zoo, 30.0))
    ok = True
    for label, name, repo, seconds in cases:
        wav = _track(seconds, 110)
        sep = Separator(name, repo=repo, shifts=1, batch_size=16, shift_offsets=(2500,))

        def run(engine, batch_size):
            sep.update_parameter(engine=engine, batch_size=batch_size)
            return _stems(sep, wav)

        served = {e: run(e, 16) for e in ("auto", "host")}
        again = {e: run(e, 16) for e in ("auto", "host")}
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            same = {e: run(e, 1) for e in ("auto", "host")}
        peak = float(np.abs(served["host"]).max())

        def diff(a, b):
            return {"bit_equal": bool(np.array_equal(a, b)),
                    "max_abs_err_over_peak": float(np.abs(a - b).max()) / peak}

        case = {"seconds": seconds, "served (batch 16)": diff(served["auto"], served["host"]),
                "device twice": diff(served["auto"], again["auto"]),
                "host twice": diff(served["host"], again["host"]),
                "same composition (batch 1), deterministic cuDNN": diff(same["auto"],
                                                                        same["host"])}
        model = sep.model.models[0] if hasattr(sep.model, "models") else sep.model
        if label != "repro_mdx_a bag":
            target = model.leaf_target(int(model.segment * SR), None)
            window = torch.from_numpy(wav[None, :, :target]).cuda()
            with torch.inference_mode():
                b1 = model.module(window)[0]
                pair = torch.cat([window, torch.zeros_like(window)])
                b2 = model.module(pair)[0]
                graph = GRAPHS.forward(model.module, pair)[0].clone()
            fpeak = b1.abs().max().item()
            case["one window"] = {
                "eager B=1 vs eager B=2": (b1 - b2).abs().max().item() / fpeak,
                "eager B=2 vs graph B=2": (b2 - graph).abs().max().item() / fpeak}
        errs = [v["max_abs_err_over_peak"] for v in case.values() if isinstance(v, dict)
                and "max_abs_err_over_peak" in v]
        ok = ok and max(errs) <= ENGINE_RTOL
        info[label] = case
        del sep
        torch.cuda.empty_cache()
    info["tol"] = ENGINE_RTOL
    info["ok"] = ok
    emit(info)
    if not ok:
        raise AssertionError(f"engines: device and host differ beyond {ENGINE_RTOL} x peak")
    return info


PRESETS = ("default", "fast", "balanced", "quality")
# Least SER of each preset's forward against the same family's fp32 forward on
# the card, in dB (tests/test_torch_cuda.py::test_presets_ser_on_card states
# the same): default and quality are the fp32 forward itself; balanced rounds
# every convolution, LSTM and product operand to TF32's 10-bit mantissa; fast
# stores HTDemucs's core in bf16 (7 bits), and leaves the other families fp32.
PRESET_SER_DB = {"default": 100.0, "quality": 100.0, "balanced": 30.0, "fast": 20.0}


def phase_presets(workdir: Path) -> tuple:
    """Each preset on each family, through Separator(compute_dtype=,
    matmul_precision=, transfer_dtype=) as the CLI's --preset resolves it for
    16-bit WAV output: HTDemucs (released widths, 7.8 s segment) at 30 s,
    median of 3; HDemucs and Demucs v2 (44 s segment) at 30 s, median of 2;
    the device engine after one warm-up request. Per preset: audio-s/s, the
    SER of its forward (float32 wire) and of its served stems against the
    family's fp32 forward (the default preset) for the same shift, peak
    allocated memory (and the requests' own, above what was allocated before
    them), the graph pool, the kernels' launches; for HTDemucs's fast preset
    one more request under torch.profiler (device time by kernel group, K3
    bf16's share)."""
    import warnings

    import torch

    from demucs_tpu_torch.api import Separator
    from demucs_tpu_torch.inference.engine import GRAPHS
    from demucs_tpu_torch.presets import resolve_preset

    info = {"phase": "presets", "ser_bounds_db": PRESET_SER_DB}
    paths = {}
    ok = True
    for label, name, repeats in (("htdemucs", "htdemucs_smoke", REPEATS),
                                 ("hdemucs", "hdemucs_smoke", FAMILY_REPEATS),
                                 ("demucs_v2", "demucs_smoke", FAMILY_REPEATS)):
        wav = _track(30.0, 120)
        ref = None
        family = {}
        for preset in PRESETS:
            compute_dtype, matmul_precision, wire, _ = resolve_preset(preset, "auto")
            wire = "int16" if wire == "auto" else wire  # the CLI's rule for 16-bit WAV
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                sep = Separator(name, repo=workdir, shifts=1, batch_size=16,
                                compute_dtype=compute_dtype, matmul_precision=matmul_precision,
                                transfer_dtype=None if wire == "float32" else wire)
            counts = Counts(sep.model.module)
            _stems(sep, wav)  # warm-up: captures the graphs
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            counts.zero()
            walls = []
            for _ in range(repeats):
                start = time.perf_counter()
                served = _stems(sep, wav)
                walls.append(time.perf_counter() - start)
            run = counts.read()
            peak = torch.cuda.max_memory_allocated()
            prof = None
            if preset == "fast" and label == "htdemucs":  # K3 bf16's share, as served
                prof = profile_request(sep, wav)
                k3 = prof["by_group_ms"].get("K3 flash_mha_bf16", 0.0)
                prof["k3_bf16_share"] = k3 / prof["device_ms"] if prof["device_ms"] else \
                    "not measured"
            sep.update_parameter(transfer_dtype=None)
            exact = _stems(sep, wav)
            if preset == "default":
                ref = exact
            # fast leaves the other families fp32: held to the default's bound
            bound_db = PRESET_SER_DB["default" if preset == "fast" and label != "htdemucs"
                                     else preset]
            ser = _ser_db(ref, exact)
            wall = sorted(walls)[len(walls) // 2]
            row = {"compute_dtype": compute_dtype, "matmul_precision": matmul_precision,
                   "wire": wire, "median_wall_s": wall, "wall_s": walls,
                   "audio_s_per_s": 30.0 / wall, "ser_db_forward": ser,
                   "ser_db_served": _ser_db(ref, served), "ser_bound_db": bound_db,
                   "max_memory_allocated_GiB": peak / 2**30,
                   # above what was allocated before the requests (weights, earlier phases)
                   "request_peak_GiB": (peak - held) / 2**30,
                   "pool_GiB": (GRAPHS.pool_bytes() or 0) / 2**30,
                   "warned": [str(w.message)[:80] for w in caught],
                   "launches": run["launches"], "launches_ok": run["ok"]}
            if prof is not None:
                row["profile"] = prof
            row["ok"] = run["ok"] and (ser == "bit-equal" or ser >= bound_db)
            if preset == "fast" and label == "htdemucs":
                row["c4"] = c4_check(sep, wav, wire)
                row["ok"] = (row["ok"] and run["launches"]["flash_mha_bf16"] > 0
                             and row["c4"]["ok"])
            ok = ok and row["ok"]
            family[preset] = row
            paths[f"{label} {preset}"] = run["launches"]
            del sep, counts
            torch.cuda.empty_cache()
        info[label] = family
    info["ok"] = ok
    emit(info)
    if not ok:
        raise AssertionError("presets: a preset's SER, launches or route is wrong")
    return info, paths


def c4_check(sep, wav, wire: str) -> dict:
    """C4 (ROADMAP Queue C): the fast preset's HTDemucs gives the same output
    bit for bit in two eager forwards and in two replays of its CUDA graph
    (a graph cache of its own), its 16-bit transposed convolutions under
    cuDNN's deterministic algorithms (``ops/nn.py::_deterministic16``); and
    the preset's audio-s/s with and without that setting: a copy of the
    module captured without it, then REPEATS requests of each in turn on the
    preset's ``wire`` (medians; the spread between runs is up to 16 %)."""
    import torch

    from demucs_tpu_torch.inference.engine import GRAPHS, GraphCache
    from demucs_tpu_torch.ops import nn as ops_nn

    module = sep.model.module
    mix = torch.from_numpy(_track(module.cfg.segment, 77)[None]).cuda().repeat(2, 1, 1)
    graphs = GraphCache()
    with torch.inference_mode():
        eager = [module(mix).clone() for _ in range(2)]
        replays = [graphs.forward(module, mix).clone() for _ in range(2)]
    graphs.clear()
    info = {"eager_bit_equal": bool(torch.equal(eager[0], eager[1])),
            "replays_bit_equal": bool(torch.equal(replays[0], replays[1])),
            "replay_vs_eager_over_peak": ((replays[0] - eager[0]).abs().max()
                                          / eager[0].abs().max()).item(),
            "deterministic_flag_after": torch.backends.cudnn.deterministic}
    loose = copy.deepcopy(module)  # its own graphs, captured with cuDNN's default algorithms
    deterministic16 = ops_nn._deterministic16
    ops_nn._deterministic16 = lambda x: contextlib.nullcontext()
    try:
        with torch.inference_mode():
            gap = [loose(mix).clone() for _ in range(2)]
        sep.model.module = loose
        _stems(sep, wav)
    finally:
        ops_nn._deterministic16 = deterministic16
        sep.model.module = module
    walls: dict = {"with": [], "without": []}
    sep.update_parameter(transfer_dtype=None if wire == "float32" else wire)
    try:
        for _ in range(REPEATS):
            for label, mod in (("with", module), ("without", loose)):
                sep.model.module = mod
                start = time.perf_counter()
                _stems(sep, wav)
                walls[label].append(time.perf_counter() - start)
    finally:
        sep.model.module = module
        sep.update_parameter(transfer_dtype=None)
        GRAPHS.clear()
    for label, got in walls.items():
        info[f"audio_s_per_s_{label}"] = 30.0 / sorted(got)[len(got) // 2]
        info[f"wall_s_{label}"] = got
    info.update(without_setting_eager_gap_over_peak=((gap[0] - gap[1]).abs().max()
                                                     / gap[0].abs().max()).item(),
                card=card_line())
    info["ok"] = (info["eager_bit_equal"] and info["replays_bit_equal"]
                  and not info["deterministic_flag_after"])
    return info


COLD_OFFSET = 1234  # samples; a shift offset no earlier request drew
PREWARM_OFFSETS = (4321, 17000)  # the pinned set prewarm() warms


def phase_prewarm(workdir: Path) -> dict:
    """HDemucs (44 s segment, exact tails) at 30 and 60 s on the device engine,
    each part on a model loaded anew (its CUDA graphs not captured yet): 3
    requests of each length with random shifts (each tail a new length);
    1 request of each with a pinned offset (cold); prewarm() with another
    pinned set, then 3 requests of each with it."""
    import random

    import torch

    from demucs_tpu_torch.api import Separator
    from demucs_tpu_torch.inference.engine import GRAPHS

    lengths = (30.0, 60.0)
    tracks = {s: _track(s, 130 + i) for i, s in enumerate(lengths)}

    def walls(sep, n, seed=None):
        out = {}
        for s in lengths:
            out[f"{s:.0f} s"] = []
            for r in range(n):
                if seed is not None:
                    random.seed(seed + r)
                start = time.perf_counter()
                sep.separate_tensor(tracks[s], SR)
                out[f"{s:.0f} s"].append(time.perf_counter() - start)
        return out

    def fresh(offsets=None):
        return Separator("hdemucs_smoke", repo=workdir, shifts=1, batch_size=16,
                         shift_offsets=offsets)

    info = {"phase": "prewarm", "model": "hdemucs (44 s segment)"}
    sep = fresh()
    info["random shifts"] = walls(sep, 3, seed=2000)
    sep = fresh((COLD_OFFSET,))
    info[f"pinned, cold (offset {COLD_OFFSET})"] = walls(sep, 1)
    sep = fresh(PREWARM_OFFSETS)
    captures = GRAPHS.captures
    start = time.perf_counter()
    info["report"] = sep.prewarm(list(lengths))
    info["prewarm_s"] = time.perf_counter() - start
    info["captures_in_prewarm"] = GRAPHS.captures - captures
    captures = GRAPHS.captures
    info[f"pinned after prewarm (offsets {PREWARM_OFFSETS})"] = walls(sep, 3)
    info["captures_after_prewarm"] = GRAPHS.captures - captures
    info["ok"] = (info["captures_in_prewarm"] > 0 and info["captures_after_prewarm"] == 0
                  and all(r["tails_warmed"] for r in info["report"]))
    del sep
    torch.cuda.empty_cache()
    emit(info)
    if not info["ok"]:
        raise AssertionError(f"prewarm: requests after it captured graphs: {info}")
    return info


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _ms_since(start: float) -> float:
    return (time.perf_counter() - start) * 1e3


def codec_libraries() -> dict:
    """Which codec libraries and binaries this machine has (absent is no failure)."""
    import ctypes.util
    import shutil

    from demucs_tpu_torch import audio, avio, mp3io

    return {"libmp3lame": mp3io.lame_available(), "libmpg123": mp3io.mpg123_available(),
            "libavcodec_headers": any(Path(d, "libavcodec", "avcodec.h").exists() for d in (
                "/usr/include", "/usr/include/x86_64-linux-gnu", "/usr/local/include")),
            "libavcodec_libraries": {n: ctypes.util.find_library(n)
                                     for n in ("avcodec", "avformat", "avutil")},
            "avio_shim": avio.available(),
            "avio_shim_absent_because": avio.unavailable_reason().splitlines()[:1],
            "ffmpeg_binaries": audio.ffmpeg_available(), "g++": shutil.which("g++")}


def phase_codecs(workdir: Path) -> dict:
    """The codecs on the host of the card's machine, on a 30 s stereo track: FLAC
    write then read at 16 and 24 bits (bit-exact against the quantized
    samples), and an mp3 write then read where LAME (and libmpg123) exist; the
    ms of each step."""
    import numpy as np

    from demucs_tpu_torch import flacio, mp3io

    begin = time.perf_counter()
    libs = codec_libraries()
    print(f"codec libraries: {json.dumps(libs)}", flush=True)
    wav = _track(CODEC_SECONDS, 150)
    info = {"phase": "codecs", "card": card_line(), "libraries": libs, "seconds": CODEC_SECONDS,
            "flac": {}}
    ok = True
    for bits in (16, 24):
        path = workdir / f"codec{bits}.flac"
        start = time.perf_counter()
        flacio.write_flac(path, wav, SR, bits_per_sample=bits)
        write_ms = _ms_since(start)
        start = time.perf_counter()
        got, sr = flacio.read_flac(path)
        read_ms = _ms_since(start)
        lim = (1 << (bits - 1)) - 1
        want = np.clip(np.round(wav.astype(np.float64) * lim), -lim - 1, lim)
        exact = bool(sr == SR and np.array_equal(got.astype(np.float64) * (1 << (bits - 1)), want))
        info["flac"][f"{bits} bit"] = {"write_ms": write_ms, "read_ms": read_ms,
                                       "bytes": path.stat().st_size, "bit_exact": exact}
        ok = ok and exact
    if libs["libmp3lame"]:
        path = workdir / "codec.mp3"
        start = time.perf_counter()
        mp3io.write_mp3(path, wav, SR, bitrate=320, quality=2)
        row = {"write_ms": _ms_since(start), "bytes": path.stat().st_size}
        if libs["libmpg123"]:
            start = time.perf_counter()
            got, sr = mp3io.read_mp3(path)
            row["read_ms"] = _ms_since(start)
            row["snr_db"] = float(10 * np.log10(np.mean(wav**2) / np.mean((got - wav) ** 2)))
            row["ok"] = sr == SR and got.shape == wav.shape and row["snr_db"] > 20
            ok = ok and row["ok"]
        info["mp3"] = row
    else:
        info["mp3"] = "absent: libmp3lame is not installed on this machine"
    info["ok"] = ok
    info["phase_s"] = time.perf_counter() - begin
    emit(info)
    if not ok:
        raise AssertionError(f"codecs: a round trip is wrong: {info}")
    return info


AUTOMIX_SONGS = ((120.0, 110.0), (126.0, 123.47), (63.0, 103.83))  # (bpm, bass Hz)
AUTOMIX_SECONDS = 6.0


def _automix_catalog(root: Path) -> Path:
    """A MusdbHQ-shaped train folder of len(AUTOMIX_SONGS) synthetic songs
    (AUTOMIX_SECONDS, 44.1 kHz stereo, from a seed): decaying noise bursts
    on every beat as drums, a pulsing tone as bass, two steady tones as
    other and vocals, the mixture their sum."""
    import numpy as np

    from demucs_tpu_torch.audio import save_audio

    rng = np.random.default_rng(11)
    t = np.arange(int(AUTOMIX_SECONDS * SR)) / SR
    for k, (bpm, hz) in enumerate(AUTOMIX_SONGS):
        folder = root / "train" / f"song_{k}"
        folder.mkdir(parents=True)
        drums = np.zeros_like(t)
        burst = rng.standard_normal(int(0.03 * SR)) * np.exp(-np.arange(int(0.03 * SR))
                                                              / (0.005 * SR))
        for beat in np.arange(0.2 + 0.1 * k, AUTOMIX_SECONDS - 0.05, 60.0 / bpm):
            i = int(beat * SR)
            drums[i:i + len(burst)] += burst[:len(t) - i]
        stems = {"drums": 0.5 * drums,
                 "bass": 0.4 * np.sin(2 * np.pi * hz * t) * (0.5 + 0.5 * np.cos(
                     2 * np.pi * t * bpm / 60) ** 2),
                 "other": 0.2 * np.sin(2 * np.pi * 3 * hz * t),
                 "vocals": 0.2 * np.sin(2 * np.pi * (440 + 20 * k) * t)}
        mix = 0.0
        for name, mono in stems.items():
            wav = (np.stack([mono, mono]) + 0.01 * rng.standard_normal((2, len(t))))
            mix = mix + wav
            save_audio(wav.astype(np.float32), folder / f"{name}.wav", SR, clip="clamp")
        save_audio((mix / 2).astype(np.float32), folder / "mixture.wav", SR, clip="clamp")
    return root


def phase_automix(workdir: Path) -> dict:
    """Host only: python -m demucs_tpu_torch.automix's main on a synthetic
    catalog (_automix_catalog): the beat tracker and chroma of every song,
    one synthetic song per catalog entry (the mixture and four stems of one
    length, finite, not silent), and the seconds it took. No card is used."""
    import numpy as np

    from demucs_tpu_torch import automix
    from demucs_tpu_torch.audio import read_audio

    begin = time.perf_counter()
    root = _automix_catalog(workdir / "automix_musdb")
    made_s = time.perf_counter() - begin
    out = workdir / "automix_out"
    start = time.perf_counter()
    automix.main(["--musdb", str(root), "--out", str(out), "--copies", "1", "--workers", "2",
                  "--cache", str(workdir / "automix_cache")])
    main_s = time.perf_counter() - start
    songs = sorted(p for p in (out / "train").iterdir() if p.is_dir())
    lengths, finite, one_length = [], True, True
    for song in songs:
        wavs = [read_audio(song / f"{name}.wav", samplerate=SR, channels=2)[0]
                for name in ("mixture",) + automix.SOURCES]
        finite = finite and all(bool(np.isfinite(w).all() and np.abs(w).max() > 0) for w in wavs)
        one_length = one_length and len({w.shape for w in wavs}) == 1
        lengths.append(wavs[0].shape[-1])
    info = {"phase": "automix", "host_only": True, "songs_in": len(AUTOMIX_SONGS),
            "songs_out": len(songs), "catalog_s": made_s, "main_s": main_s,
            "backend": "librosa" if importlib.util.find_spec("librosa") else "ops/beats.py",
            "min_len_s": min(lengths) / SR if lengths else 0.0}
    info["ok"] = len(songs) == len(AUTOMIX_SONGS) and finite and one_length
    emit(info)
    if not info["ok"]:
        raise AssertionError(f"automix: {info}")
    return info


SERVE_OFFSETS = (2500, 8000)  # the server's pinned --shift-offsets


def phase_serve(workdir: Path) -> tuple:
    """SeparationService with the released-width HTDemucs (the serving phase's
    .dmx) on the card, pinned shift offsets, make_server on 127.0.0.1 port 0
    in a thread. After a warm-up request (graph captures), 30 s bodies as WAV,
    FLAC and (with LAME and a decoder) mp3, and WAV bodies answered as wav,
    flac and (with LAME) mp3, each twice: audio-s/s per request and response
    format and the wall split into decode, separation and encode plus zip,
    with the kernels' launches counted over them. Then: the float32 WAV
    response against Separator.separate_tensor on the decoded body, bit for
    bit; a ?shifts=0 request followed by a parameterless one, which must equal
    the earlier parameterless response; a truncated and an ADTS-headed body,
    which must get error statuses, and a request after them."""
    import threading
    import urllib.error
    import urllib.request

    import numpy as np

    from demucs_tpu_torch import audio, mp3io
    from demucs_tpu_torch.serve import SeparationService, make_server

    begin = time.perf_counter()
    libs = codec_libraries()
    service = SeparationService("htdemucs_smoke", repo=workdir, device="cuda", shifts=1,
                                shift_offsets=SERVE_OFFSETS, batch_size=16)
    sep = service.separator
    counts = Counts(sep.model.module)
    wav = _track(30.0, 140)
    bodies = {}
    for kind in ("wav", "flac", "mp3"):
        path = workdir / f"serve_body.{kind}"
        if kind == "mp3" and not (libs["libmp3lame"] and (libs["libmpg123"] or libs["avio_shim"])):
            continue
        audio.save_audio(wav, path, SR, clip="none", as_float=kind == "wav")
        bodies[kind] = path.read_bytes()
    formats = ["wav", "flac"] + (["mp3"] if libs["libmp3lame"] else [])

    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(query: str, body: bytes) -> tuple:
        start = time.perf_counter()
        req = urllib.request.Request(f"{base}/separate{query}", data=body, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                return resp.status, resp.read(), time.perf_counter() - start
        except urllib.error.HTTPError as err:
            return err.code, err.read(), time.perf_counter() - start

    def stems(blob: bytes, fmt: str = "wav") -> dict:
        import io
        import zipfile

        out = {}
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            for name in sorted(zf.namelist()):
                path = workdir / f"served_{name}"
                path.write_bytes(zf.read(name))
                out[name] = audio.read_audio(path)[0] if fmt != "mp3" or libs["libmpg123"] \
                    else path.stat().st_size
        return out

    info = {"phase": "serve", "card": card_line(), "model": "htdemucs (released widths, 7.8 s)",
            "shift_offsets": SERVE_OFFSETS, "seconds": 30.0, "requests": {}}
    try:
        health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=60).read())
        n_models = len(json.loads(urllib.request.urlopen(f"{base}/models", timeout=60).read())[
            "models"])
        status, _, wall = post("?float32=1&clip=none", bodies["wav"])  # warm-up: captures
        info["warmup_s"] = wall
        if status != 200:
            raise AssertionError(f"serve: the warm-up request got {status}")
        counts.zero()
        plan = [(f"{b} body -> wav", b, "wav") for b in bodies] + [
            (f"wav body -> {f}", "wav", f) for f in formats if f != "wav"]
        first_wav = None
        for label, body, fmt in plan:
            query = f"?format={fmt}" + ("&float32=1&clip=none" if body == fmt == "wav" else "")
            walls, splits = [], []
            for _ in range(SERVE_REPEATS):
                status, blob, wall = post(query, bodies[body])
                if status != 200:
                    raise AssertionError(f"serve: {label} got {status}: {blob[:300]!r}")
                walls.append(wall)
                splits.append(dict(service.last_timing))
            if body == fmt == "wav":
                first_wav = blob
            got = stems(blob, fmt)
            if len(got) != 4 or not all(isinstance(v, int) or (v.shape == wav.shape and
                                                               np.isfinite(v).all())
                                        for v in got.values()):
                raise AssertionError(f"serve: {label} gave wrong stems")
            median = sorted(walls)[len(walls) // 2]
            info["requests"][label] = {
                "wall_s": walls, "audio_s_per_s": 30.0 / median,
                "split_s": {k: sorted(s[k] for s in splits)[len(splits) // 2]
                            for k in splits[0]},
                "response_bytes": len(blob)}
        run = counts.read()
        info["launches"] = run["launches"]
        info["launches_ok"] = run["ok"] and run["eager_forwards"] == 0
        info["graph_replays"] = run["graph_replays"]

        decoded, _ = audio.read_audio(workdir / "serve_body.wav", samplerate=SR, channels=2)
        _, want = sep.separate_tensor(decoded)
        served = stems(first_wav)
        info["stems_bit_equal"] = all(np.array_equal(served[f"{k}.wav"], v)
                                      for k, v in want.items())

        status, _, _ = post("?shifts=0&float32=1&clip=none", bodies["wav"])
        _, after, _ = post("?float32=1&clip=none", bodies["wav"])
        info["overrides"] = {"shifts=0 status": status, "shifts after": sep._shifts,
                             "parameterless unchanged": all(
                                 np.array_equal(a, b) for a, b in zip(
                                     stems(after).values(), served.values()))}
        adts = b"\xff\xf1\x50\x80\x2e\x7f\xfc" + np.random.default_rng(0).integers(
            0, 256, 4000, dtype=np.uint8).tobytes()
        bad = {"truncated flac": post("", bodies["flac"][: len(bodies["flac"]) // 2])[0],
               "adts header": post("", adts)[0]}
        bad["next request"] = post("?float32=1&clip=none", bodies["wav"])[0]
        info["bad_bodies"] = bad
        info["healthz"] = health
        info["models_listed"] = n_models
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    info["ok"] = (info["launches_ok"] and info["stems_bit_equal"]
                  and info["overrides"]["shifts=0 status"] == 200
                  and info["overrides"]["shifts after"] == 1
                  and info["overrides"]["parameterless unchanged"]
                  and bad["truncated flac"] >= 400 and bad["adts header"] >= 400
                  and bad["next request"] == 200 and not thread.is_alive())
    info["phase_s"] = time.perf_counter() - begin
    emit(info)
    if not info["ok"]:
        raise AssertionError(f"serve: {info}")
    return info, run["launches"]


def _streamed(stream, mix, sizes) -> tuple:
    """Feed ``mix (C, T)`` to ``stream`` in chunks of ``sizes``, flush: (stems, wall s)."""
    import numpy as np

    parts, pos = [], 0
    start = time.perf_counter()
    for n in sizes:
        parts.append(stream.feed(mix[:, pos:pos + n]))
        pos += n
    parts.append(stream.flush())
    return np.concatenate(parts, axis=-1)[None], time.perf_counter() - start


def phase_streaming(workdir: Path) -> tuple:
    """StreamSeparator on the card: HTDemucs (released widths, 7.8 s) over 30 s
    and Demucs v2 (44 s segment) over 60 s, fed in ragged chunks drawn from a
    seed. A first run captures the graph of the full segments; the second is
    timed and counted; a third runs every segment eagerly. The streamed stems
    against apply_model(shifts=0) on the card (1e-5 x peak, ENGINE_RTOL) and
    the graph replays against the eager run (1e-6 x peak, GRAPH_RTOL)."""
    import numpy as np

    from demucs_tpu_torch.inference import streaming
    from demucs_tpu_torch.inference.apply import apply_model
    from demucs_tpu_torch.zoo.pretrained import get_model

    begin = time.perf_counter()
    info = {"phase": "streaming", "card": card_line()}
    paths = {}
    ok = True
    for label, name, seconds in (("htdemucs", "htdemucs_smoke", 30.0),
                                 ("demucs_v2", "demucs_smoke", 60.0)):
        model = get_model(name, workdir, device="cuda")
        counts = Counts(model.module)
        mix = _track(seconds, 160)
        rng = np.random.default_rng(161)
        sizes, left = [], mix.shape[-1]
        while left:
            sizes.append(int(min(left, rng.integers(1000, 100000))))
            left -= sizes[-1]
        _streamed(streaming.StreamSeparator(model), mix, sizes)  # captures the graph
        counts.zero()
        stream = streaming.StreamSeparator(model)
        got, wall = _streamed(stream, mix, sizes)
        run = counts.read()
        forward = streaming._forward
        streaming._forward = lambda module, batch: module(batch)
        try:
            eager, _ = _streamed(streaming.StreamSeparator(model), mix, sizes)
        finally:
            streaming._forward = forward
        want = apply_model(model, mix[None], shifts=0)
        peak = float(np.abs(want).max())
        row = {"chunks": len(sizes), "graph_replays": stream.graph_segments,
               "eager_tails": stream.eager_segments,
               "ms_per_segment": wall * 1e3 / (stream.graph_segments + stream.eager_segments),
               "wall_s": wall, "latency_s": stream.latency_samples / SR,
               "real_time_factor": seconds / wall,
               "vs_apply_model": float(np.abs(got - want).max()) / peak, "tol": ENGINE_RTOL,
               "replay_vs_eager": float(np.abs(got - eager).max()) / peak,
               "replay_tol": GRAPH_RTOL, "launches": run["launches"],
               "launches_ok": run["ok"] and run["graph_replays"] == stream.graph_segments}
        row["ok"] = (got.shape == want.shape and row["vs_apply_model"] <= ENGINE_RTOL
                     and row["replay_vs_eager"] <= GRAPH_RTOL and row["launches_ok"]
                     and stream.graph_segments > 0 and stream.eager_segments > 0)
        ok = ok and row["ok"]
        info[label] = row
        paths[f"streaming {label}"] = run["launches"]
        del model, counts
    info["ok"] = ok
    info["phase_s"] = time.perf_counter() - begin
    emit(info)
    if not ok:
        raise AssertionError(f"streaming: {info}")
    return info, paths


def _write_pcm16(path: Path, wav, samplerate: int) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(samplerate)
        w.writeframes((wav.T * (2**15 - 1)).astype("<i2").tobytes())


def run_cli(workdir: Path, repo: Path, name: str, samplerate: int, fmt: str = "wav",
            out_flag: tp.Optional[str] = None) -> dict:
    """``python -m demucs_tpu_torch track.<fmt> -n NAME --repo REPO [--flac|--mp3]``
    on a 5 s track at ``samplerate`` (WAV or FLAC): exit code 0 and four stems
    of 5 s at 44.1 kHz in the output format."""
    import os

    import numpy as np

    from demucs_tpu_torch import audio, mp3io

    t = np.arange(5 * samplerate) / samplerate
    tones = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * np.sin(2 * np.pi * 3000.0 * t)
    wav = np.stack([tones, 0.8 * tones]).astype(np.float32)
    track = workdir / f"track{samplerate}.{fmt}"
    if fmt == "wav":
        _write_pcm16(track, wav, samplerate)
    else:
        audio.save_audio(wav, track, samplerate)
    out = workdir / "separated"
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "demucs_tpu_torch", str(track), "--repo",
                           str(repo), "-n", name, "-o", str(out), *([out_flag] if out_flag else [])],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    ext = out_flag[2:] if out_flag else "wav"
    stems = sorted((out / name / track.stem).glob(f"*.{ext}"))
    readable = ext != "mp3" or mp3io.mpg123_available()
    shapes = {p.name: ((audio.read_audio(p)[0].shape, audio.read_audio(p)[1]) if readable
                       else ((2, 5 * SR), SR)) for p in stems}
    ok = (proc.returncode == 0
          and sorted(shapes) == [f"{s}.{ext}" for s in ("bass", "drums", "other", "vocals")]
          and all(v == ((2, 5 * SR), SR) for v in shapes.values())
          and all(p.stat().st_size > 0 for p in stems))
    info = {"model": name, "input": f"{fmt} at {samplerate} Hz", "output": ext,
            "read_back": readable, "rc": proc.returncode,
            "stems": {k: [list(v[0]), v[1]] for k, v in shapes.items()},
            "wall_s": time.perf_counter() - start, "ok": ok}
    if not ok:
        raise AssertionError(f"CLI failed: {info}\n{proc.stdout}\n{proc.stderr}")
    return info


def phase_cli(workdir: Path, zoo: Path, bag: str) -> None:
    """The CLI with the HTDemucs .dmx on a WAV at 44.1 kHz, then with the
    repro_mdx_a-shape bag of .th files on a 48 kHz FLAC input, which it
    resamples, with --flac output; then the .dmx with --mp3 where LAME
    exists."""
    from demucs_tpu_torch import mp3io

    runs = [run_cli(workdir, workdir, "htdemucs_smoke", SR),
            run_cli(workdir, zoo, bag, 48000, "flac", "--flac")]
    if mp3io.lame_available():
        runs.append(run_cli(workdir, workdir, "htdemucs_smoke", SR, "flac", "--mp3"))
    else:
        runs.append({"output": "mp3", "ok": True,
                     "skipped": "libmp3lame is not installed on this machine"})
    emit({"phase": "cli", "card": card_line(), "runs": runs, "ok": all(r["ok"] for r in runs)})


# ---------------------------------------------------------------------------
# HTDemucs's remaining options: K3 under the static sparse masks, the
# variants end to end, the memory report, test-set evaluation
# ---------------------------------------------------------------------------

SPARSE_MASKS = ("diag", "global", "jmask", "random", "diag_jmask_random")
# the reference's mask defaults (HTDemucsConfig): window 500, global 100, sparsity 0.95
MASK_DEFAULTS = dict(sparse_attn_window=500, global_window=100, mask_random_seed=42,
                     sparsity=0.95)
SPARSE = dict(t_sparse_self_attn=True, t_sparse_cross_attn=True)
VARIANTS = {  # released widths, 7.8 s segment
    "sparse diag": SPARSE,
    "sparse diag_jmask_random": dict(SPARSE, t_mask_type="diag_jmask_random"),
    "lsh": dict(SPARSE, t_auto_sparsity=True),
    "cape": dict(t_emb="cape"),
    "cac=False wiener 1": dict(cac=False, wiener_iters=1),
    "multi_freqs": dict(multi_freqs=(0.25, 0.5)),
}
VARIANT_REPEATS = 3  # each 30 s variant request, median reported
LSH_MASK_DIFF = 1e-3  # share of LSH keep-mask entries the card may flip against the CPU
EVAL_TRACKS, EVAL_SECONDS = 1, 10.0
EVAL_NSDR_TOL = 1e-4  # dB: evaluate()'s nsdr against eval_track on Separator's stems


def unit_shares(mask, rows: int, keys: int) -> dict:
    """The share of a plan's (row block, key tile) units that keep a score,
    and that keep every in-range score (kernels/attention.py tile_classes)."""
    from demucs_tpu_torch.kernels import attention as KA

    classes = KA.tile_classes(mask.bool().cpu().numpy(), rows, keys)
    return {"nonempty": float((classes > 0).mean()), "full": float((classes == 2).mean())}


def f32_instances(report: tp.Optional[str] = None) -> dict:
    """Registers and spills of each instance of K3's fp32 forward kernel (d,
    rows per block, with or without a mask) from nvcc's report of the library
    loaded, or of ``report``."""
    from demucs_tpu_torch.kernels import _build

    found = ptxas_kernels(_build.ptxas_report("flash_mha") if report is None else report,
                          r"flash_mha_kernelILi(\d+)ELi(\d+)ELb([01])E")
    return {f"d={k.split()[0]} rows={64 * int(k.split()[1])}"
            + (" masked" if k.split()[2] == "1" else ""): v for k, v in found.items()}


def phase_sparse_kernels(pair: tp.Optional[list] = None) -> dict:
    """K3 under each static mask (diag, global, jmask, random and their union
    diag_jmask_random, at the reference's window 500, global 100, sparsity
    0.95; built by ops/sparse.py as the transformer caches them) at the four
    released shapes and B = 1 and 6: the fp32 route and the bf16 route on
    its chosen plan and on every plan of its sweep against the plain version
    on the same inputs (NaN only where the plain version has it), timed (the bf16 route on its
    chosen plan) beside the same shape unmasked and beside SDPA with the
    same boolean mask (yardstick only). Bounds count the kept scores only
    (a masked score is work the function need not do) and the mask as bits.
    Per row also the share of each route's plan's (row block, key tile)
    units that keep a score and that are full, and the registers and spills
    of the instance it launches (masked and unmasked launches share it);
    with ``pair`` (the --k3-pair libraries, the parent tree first and this
    one second) both trees' times, masked and unmasked, in turns (parent,
    change, change, parent). Then K3's backward under each mask on both
    routes at the four shapes and B = 1 and 8 (sparse_backward: the masked
    instances, paired with the parent's under ``pair``) beside SDPA's
    backward with the same boolean mask (autograd.grad), against the plain
    backward at B = 1, its bound on
    the kept scores: 5 x 2 B H d kept operations (3 x that in 3xTF32)."""
    import torch
    import torch.nn.functional as F

    from demucs_tpu_torch.kernels import attention as KA
    from demucs_tpu_torch.models.htdemucs import precision_scope
    from demucs_tpu_torch.ops.sparse import keep_mask

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    C, H = 512, 8
    d = C // H
    tokens = {"freq": 2688, "time": 1344}
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    b_inst, f_inst = bf16_instances(), f32_instances()
    rows = {}
    worst_fp32, worst_bf16 = 0.0, -math.inf

    def paired(cases: dict) -> dict:
        """Each case's ms on each tree of ``pair``, in turns, the mean of two readings."""
        times = {name: [[] for _ in pair] for name in cases}
        for i in list(range(len(pair))) + list(reversed(range(len(pair)))):
            with _pair_libs(pair[i]):
                for name, fn in cases.items():
                    times[name][i].append(cuda_ms(fn))
        return {name: [sum(t) / len(t) for t in per] for name, per in times.items()}

    with precision_scope(None):
        for batch in (1, 6):
            for tq_name, tk_name in (("freq", "freq"), ("time", "time"), ("freq", "time"),
                                     ("time", "freq")):
                Tq, Tk = tokens[tq_name], tokens[tk_name]
                q, k, v = (torch.randn(batch, T, C, device=dev, generator=gen)
                           for T in (Tq, Tk, Tk))
                qb, kb, vb = (t.bfloat16() for t in (q, k, v))
                split = [t.view(batch, -1, H, d).transpose(1, 2) for t in (q, k, v)]
                split_b = [t.view(batch, -1, H, d).transpose(1, 2) for t in (qb, kb, vb)]
                key = f"B={batch} {tq_name}<-{tk_name}"
                unmasked = {"ms": cuda_ms(lambda: KA.flash_mha(q, k, v, H)),
                            "bf16_ms": cuda_ms(lambda: KA.flash_mha(qb, kb, vb, H))}
                if pair:
                    unmasked["pair"] = paired({
                        "ms": lambda: KA._forward_f32(q, k, v, H, None, 0.0, 0, False),
                        "bf16_ms": lambda: KA._forward_bf16(qb, kb, vb, H, None, 0.0, 0, False)})
                rows_b, ctas = KA.bf16_plan(batch, Tq, Tk, H, sm)
                for mask_type in SPARSE_MASKS:
                    mask = keep_mask(Tq, Tk, mask_type, device=dev, **MASK_DEFAULTS)
                    keep = mask.bool()
                    kept = int(keep.sum().item())
                    err = fp32_err(KA.flash_mha(q, k, v, H, mask=mask),
                                   KA.flash_mha_plain(q, k, v, H, mask=mask))
                    want = KA.flash_mha_plain(qb, kb, vb, H, mask=mask)
                    by_plan = {"chosen": bf16_excess(KA.flash_mha(qb, kb, vb, H, mask=mask),
                                                     want)}
                    for bk, r, persistent in BF16_PLANS:
                        with bf16_plan(KEY_TILE_BF16=bk, BF16_ROWS=r, BF16_PERSISTENT=persistent):
                            by_plan[f"{bk} keys {r} rows "
                                    f"{'persistent' if persistent else 'grid'}"] = bf16_excess(
                                KA.flash_mha(qb, kb, vb, H, mask=mask), want)
                    excess = max(by_plan.values())
                    worst_fp32, worst_bf16 = max(worst_fp32, err), max(worst_bf16, excess)
                    flops = 4 * batch * H * d * kept  # the kept scores' two products
                    mask_bytes = -(-Tq * Tk // 8)  # the mask as bits
                    b32, by32 = bound(3 * flops, 4 * 2 * batch * (Tq + Tk) * C + mask_bytes,
                                      TF32_FLOPS)
                    b16, by16 = bound(flops, 2 * 2 * batch * (Tq + Tk) * C + mask_bytes,
                                      BF16_FLOPS)
                    tiles = KA.mask_tiles(mask)
                    rows_m, ctas_m = KA.bf16_plan(batch, Tq, Tk, H, sm, tiles)
                    blocks_m = -(-Tq // rows_m) * H * batch
                    row = dict(
                        kept_share=kept / (Tq * Tk), max_abs_err=err,
                        bf16_worst_excess_over_tol=excess, bf16_excess_by_plan=by_plan,
                        ms=cuda_ms(lambda: KA.flash_mha(q, k, v, H, mask=mask)),
                        unmasked_ms=unmasked["ms"],
                        sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                            *split, attn_mask=keep)),
                        bound_ms=b32, bound_by=by32,
                        bf16_ms=cuda_ms(lambda: KA.flash_mha(qb, kb, vb, H, mask=mask)),
                        bf16_unmasked_ms=unmasked["bf16_ms"],
                        sdpa_bf16_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                            *split_b, attn_mask=keep)),
                        bf16_bound_ms=b16, bf16_bound_by=by16,
                        units=unit_shares(mask, KA.BLOCK_ROWS, KA.KEY_TILE),
                        bf16_plan=(f"{KA.KEY_TILE_BF16} keys {rows_m} rows "
                                   f"{'grid' if ctas_m == blocks_m else 'persistent'} "
                                   f"{ctas_m} blocks (unmasked: {rows_b} rows {ctas} blocks)"),
                        bf16_units=unit_shares(mask, rows_m, KA.KEY_TILE_BF16),
                        instance=f_inst.get(f"d={d} rows={KA.BLOCK_ROWS} masked"),
                        bf16_instance=b_inst.get(
                            f"d={d} keys={KA.KEY_TILE_BF16} rows={rows_m} masked"))
                    row["over_unmasked"] = row["ms"] / row["unmasked_ms"]
                    row["bf16_over_unmasked"] = row["bf16_ms"] / row["bf16_unmasked_ms"]
                    row["bf16_over_sdpa"] = row["bf16_ms"] / row["sdpa_bf16_ms"]
                    if pair:
                        times = paired({
                            "ms": lambda: k3_forward("f32", q, k, v, H, mask),
                            "bf16_ms": lambda: k3_forward("bf16", qb, kb, vb, H, mask),
                            # the masked dropout instances add a piece's first row
                            "bf16_ms_dropout": lambda: k3_forward("bf16", qb, kb, vb, H, mask,
                                                                  TRAIN_DROPOUT, 5)})
                        row["pair"] = dict(times, unmasked=unmasked["pair"])
                    if key == "B=1 freq<-freq":
                        row["plain_ms"] = cuda_ms(
                            lambda: KA.flash_mha_plain(q, k, v, H, mask=mask))
                        row["bf16_plain_ms"] = cuda_ms(
                            lambda: KA.flash_mha_plain(qb, kb, vb, H, mask=mask))
                    rows[f"{key} {mask_type}"] = row
                del q, k, v, qb, kb, vb, split, split_b
                torch.cuda.empty_cache()
        backward, worst_bwd, bwd_rows, bwd_inst = sparse_backward(gen, pair)
    ratios = [r["ms"] / r["unmasked_ms"] for r in rows.values()]
    ratios_b = [r["bf16_ms"] / r["bf16_unmasked_ms"] for r in rows.values()]
    pairs = {name: [r["pair"][name][-1] / r["pair"][name][0] for r in rows.values()]
             for name in ("ms", "bf16_ms", "bf16_ms_dropout")} if pair else {}
    spills = [v for v in (*b_inst.values(), *f_inst.values())
              if v.get("spill_stores") or v.get("spill_loads")]
    info = {"phase": "sparse_kernels", "card": card_line(), "masks": list(SPARSE_MASKS),
            "mask_options": MASK_DEFAULTS, "fp32_tol": K3_ATOL, "bf16_tol": K3_BF16_TOL,
            "worst_fp32_err": worst_fp32, "worst_bf16_excess_over_tol": worst_bf16,
            "masked_over_unmasked": {"fp32": [min(ratios), max(ratios)],
                                     "bf16": [min(ratios_b), max(ratios_b)]},
            # --k3-pair: the last tree's time over the first's, each masked forward
            "pair_last_over_first": {k: [min(v), max(v)] for k, v in pairs.items()},
            "bf16_over_sdpa": [min(r["bf16_over_sdpa"] for r in rows.values()),
                               max(r["bf16_over_sdpa"] for r in rows.values())],
            "bound_rule": "kept scores only: fp32 max(3 x 4 B H d kept / 495 TFLOP/s, bytes / "
                          "3.35 TB/s), bf16 max(4 B H d kept / 989 TFLOP/s, bf16 bytes / "
                          "3.35 TB/s); bytes: q, k, v, o once and the mask as bits "
                          "(Tq Tk / 8)",
            "instances_spilling": spills, "rows": rows, "backward": backward,
            "backward_worst_err_over_peak": worst_bwd, "backward_instances": bwd_inst,
            "backward_over_unmasked": {
                r: [min(b["over_unmasked"] for k, b in backward.items() if k.startswith(r)),
                    max(b["over_unmasked"] for k, b in backward.items() if k.startswith(r))]
                for r in ("fp32", "bf16")},
            "backward_over_sdpa": {
                r: [min(b["over_sdpa"] for k, b in backward.items() if k.startswith(r)),
                    max(b["over_sdpa"] for k, b in backward.items() if k.startswith(r))]
                for r in ("fp32", "bf16")}}
    info["kernel_rows"] = bwd_rows
    info["ok"] = (worst_fp32 <= K3_ATOL and worst_bf16 <= 0 and not spills
                  and all(r["ok"] for r in bwd_rows))
    emit(info)
    if not info["ok"]:
        raise AssertionError(f"K3 under sparse masks disagrees with the plain version: "
                             f"fp32 {worst_fp32}, bf16 excess {worst_bf16}, backward "
                             f"{worst_bwd}, spilling instances {spills}")
    return info


def bwd_unit_shares(mask, keys: int, qt: int) -> dict:
    """The share of a backward plan's (key block, query tile) units that keep
    a score, and that keep every in-range score (kernels/attention.py
    bwd_tile_map), and the most units one key block walks."""
    from demucs_tpu_torch.kernels import attention as KA

    tm = KA.bwd_tile_map(mask.bool().cpu().numpy(), keys, qt)
    classes = tm["classes"]
    return {"nonempty": float((classes > 0).mean()), "full": float((classes == 2).mean()),
            "longest_walk": max(tm["counts"]), "n_qt": classes.shape[1]}


def sparse_backward(gen, pair: tp.Optional[list] = None) -> tuple:
    """K3's backward on both routes under each static mask at the four
    shapes and B = 1 and 8 (the masked instances: a tile map per plan, bits
    on partial units), timed beside the same shape unmasked and SDPA's
    backward with the same boolean mask; at B = 1 dQ, dK, dV against the
    plain backward formula, by default and under deterministic() (two
    launches bit-equal); each row's plan's unit shares and the masked
    instance's registers and spills; with ``pair`` (the --k3-pair
    libraries) each tree's masked and unmasked times in turns. Returns
    ({case: row}, the worst error over each gradient's peak by route, the
    masked backward rows of the kernels line)."""
    import torch
    import torch.nn.functional as F

    from demucs_tpu_torch.kernels import attention as KA
    from demucs_tpu_torch.ops.sparse import keep_mask

    dev = torch.device("cuda")
    C, H = 512, 8
    d = C // H
    tokens = {"freq": 2688, "time": 1344}
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    instances = {"fp32": bwd_instances("F32Bwd", masked=True),
                 "bf16": bwd_instances("Bf16Bwd", masked=True)}
    rows, worst = {}, {"fp32": 0.0, "bf16": 0.0}
    det_equal = True

    def paired(cases: dict) -> dict:
        times = {name: [[] for _ in pair] for name in cases}
        for i in list(range(len(pair))) + list(reversed(range(len(pair)))):
            with _pair_libs(pair[i]):
                for name, fn in cases.items():
                    times[name][i].append(cuda_ms(fn))
        return {name: [sum(t) / len(t) for t in per] for name, per in times.items()}

    for batch in (1, 8):
        for tq_name, tk_name in (("freq", "freq"), ("time", "time"), ("freq", "time"),
                                 ("time", "freq")):
            Tq, Tk = tokens[tq_name], tokens[tk_name]
            q32, k32, v32, do32 = (torch.randn(batch, T, C, device=dev, generator=gen)
                                   for T in (Tq, Tk, Tk, Tq))
            for route, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                q, k, v, do = (t.to(dtype) for t in (q32, k32, v32, do32))
                backward = KA.flash_mha_bwd if route == "fp32" else KA.flash_mha_bwd_bf16
                launch = KA._forward_f32 if route == "fp32" else KA._forward_bf16
                name = "f32" if route == "fp32" else "bf16"
                size = 4 if route == "fp32" else 2
                keys = 64 if route == "fp32" else KA.bwd_keys(batch, Tk, H, sm)
                qt = 32 if route == "fp32" else 64
                o_u, lse_u = launch(q, k, v, H, None, 0.0, 0, True)
                unmasked_ms = cuda_ms(lambda: backward(q, k, v, o_u, do, H, lse=lse_u))
                unmasked_pair = (paired({"ms": lambda: k3_backward(name, q, k, v, o_u, do, H,
                                                                   lse_u, None)})["ms"]
                                 if pair else None)
                del o_u, lse_u
                for mask_type in SPARSE_MASKS:
                    mask = keep_mask(Tq, Tk, mask_type, device=dev, **MASK_DEFAULTS)
                    keep = mask.bool()
                    kept = int(keep.sum().item())
                    o, lse = launch(q, k, v, H, KA.mask_tiles(mask), 0.0, 0, True)
                    split = [t.view(batch, -1, H, d).transpose(1, 2).detach().clone()
                             .requires_grad_() for t in (q, k, v)]
                    so = F.scaled_dot_product_attention(*split, attn_mask=keep)
                    sdo = do.view(batch, Tq, H, d).transpose(1, 2)
                    flops = 5 * 2 * batch * H * d * kept
                    nbytes = (size * batch * (3 * Tq + 4 * Tk) * C + 4 * batch * H * Tq
                              + -(-Tq * Tk // 8))  # the mask as bits
                    b_ms, b_by = (bound(3 * flops, nbytes, TF32_FLOPS) if route == "fp32"
                                  else bound(flops, nbytes, BF16_FLOPS))
                    row = dict(kept_share=kept / (Tq * Tk),
                               ms=cuda_ms(lambda: backward(q, k, v, o, do, H, lse=lse,
                                                           mask=mask)),
                               unmasked_ms=unmasked_ms,
                               sdpa_bwd_ms=cuda_ms(lambda: torch.autograd.grad(
                                   so, split, sdo, retain_graph=True)),
                               bound_ms=b_ms, bound_by=b_by, keys=keys,
                               units=bwd_unit_shares(mask, keys, qt),
                               instance=instances[route].get(f"d={d}" + (
                                   "" if route == "fp32" else f" keys={keys}")))
                    row["over_unmasked"] = row["ms"] / unmasked_ms
                    row["over_sdpa"] = row["ms"] / row["sdpa_bwd_ms"]
                    row["bound_share"] = b_ms / row["ms"]
                    if batch == 1:
                        got = backward(q, k, v, o, do, H, lse=lse, mask=mask)
                        want = KA.flash_mha_bwd_plain(q, k, v, o, do, H, mask=mask)
                        row["dq_dk_dv_err_over_peak"] = [_grad_err(g.float(), w.float())
                                                         for g, w in zip(got, want)]
                        with deterministic():
                            twice = [backward(q, k, v, o, do, H, lse=lse, mask=mask)
                                     for _ in range(2)]
                        row["deterministic_dq_dk_dv_err_over_peak"] = [
                            _grad_err(g.float(), w.float()) for g, w in zip(twice[0], want)]
                        row["deterministic_equal"] = all(bool(torch.equal(a, b))
                                                         for a, b in zip(*twice))
                        det_equal = det_equal and row["deterministic_equal"]
                        worst[route] = max(worst[route], *row["dq_dk_dv_err_over_peak"],
                                           *row["deterministic_dq_dk_dv_err_over_peak"])
                        del got, want, twice
                    if pair:
                        times = paired({"ms": lambda: k3_backward(name, q, k, v, o, do, H, lse,
                                                                  mask)})
                        row["pair"] = dict(times, unmasked=unmasked_pair)
                        row["pair_change_over_parent"] = times["ms"][-1] / times["ms"][0]
                    if batch == 8 and tq_name == tk_name == "freq" and mask_type == "diag":
                        row["plain_ms"] = cuda_ms(lambda: KA.flash_mha_bwd_plain(
                            q, k, v, o, do, H, mask=mask), repeat=3)
                    rows[f"{route} B={batch} {tq_name}<-{tk_name} {mask_type}"] = row
                    del o, lse, split, so
                del q, k, v, do
            del q32, k32, v32, do32
            torch.cuda.empty_cache()
    kernel_rows = []
    for route, name in (("fp32", "flash_mha_bwd"), ("bf16", "flash_mha_bwd_bf16")):
        main = rows[f"{route} B=8 freq<-freq diag"]
        kernel_rows.append(dict(
            name=f"{name} masked", source="demucs_tpu_torch/csrc/flash_mha_bwd_masked.cu",
            replaces="demucs_tpu/ops/pallas/attention.py:103 under its keep-mask (:59-63; the "
                     "gradient: the Pallas kernel has no backward, JAX trains through XLA's "
                     "dense attention under the mask)",
            max_abs_err=worst[route], max_err_is="over each gradient's peak", ms=main["ms"],
            plain_ms=main["plain_ms"], library_ms=main["sdpa_bwd_ms"],
            library="autograd.grad of F.scaled_dot_product_attention with the boolean mask",
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            shape=f"q, k, v (B=8, 2688, 512), 8 heads, diag mask (freq self)",
            ok=worst[route] <= (K3_BWD_RTOL if route == "fp32" else K3_BF16_BWD_RTOL)
            and det_equal and _no_spills(instances[route])))
    return rows, worst, kernel_rows, instances


def variant_model(kw: dict, seed: int = 0, **extra):
    """The released-width HTDemucs with options ``kw`` at the 7.8 s segment,
    seeded random weights, unit LayerScales, random norms, on the CPU."""
    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs

    cfg = HTDemucsConfig(segment=7.8, **RELEASED, **kw, **extra)
    return init_htdemucs(cfg, seed=seed, layer_scale=1.0, random_norms=True).eval()


def lsh_checks(cpu_model) -> dict:
    """The LSH variant, whose keep-masks are data-dependent top-k sets: the
    share of mask entries that flip between the card and the CPU on the same
    projected q and k (a score within rounding of the threshold may flip), two
    card forwards bit-equal, and finite stems."""
    import torch

    from demucs_tpu_torch.ops.sparse import dynamic_sparse_keep_mask

    enc = cpu_model.crosstransformer
    R = enc.lsh_projections
    gen = torch.Generator().manual_seed(21)
    flips = {}
    for name, (Tq, Tk) in (("freq<-freq", (2688, 2688)), ("time<-freq", (1344, 2688))):
        q = torch.randn(1, Tq, 512, generator=gen)
        k = q if Tq == Tk else torch.randn(1, Tk, 512, generator=gen)
        want = dynamic_sparse_keep_mask(q, k, 8, cpu_model.cfg.t_sparsity, R)
        got = dynamic_sparse_keep_mask(q.cuda(), k.cuda(), 8, cpu_model.cfg.t_sparsity,
                                       R.cuda()).cpu()
        flips[name] = (got != want).float().mean().item()
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    mix = torch.randn(1, 2, int(7.8 * SR), generator=torch.Generator().manual_seed(1)) * 0.1
    with torch.inference_mode():
        a = gpu_model(mix.cuda()).cpu()
        b = gpu_model(mix.cuda()).cpu()
        start = time.perf_counter()
        want = cpu_model(mix)
        cpu_s = time.perf_counter() - start
    del gpu_model
    peak = want.abs().max().item()
    return {"mask_flip_share": flips, "mask_flip_tol": LSH_MASK_DIFF,
            "card_runs_bit_equal": bool(torch.equal(a, b)), "finite": bool(torch.isfinite(a).all()),
            "max_abs_err_over_peak_info": (a - want).abs().max().item() / peak,
            "cpu_forward_s": cpu_s,
            "ok": max(flips.values()) <= LSH_MASK_DIFF and bool(torch.equal(a, b))
            and bool(torch.isfinite(a).all()) and a.shape == want.shape}


def variant_requests(workdir: Path, models: dict) -> tp.Tuple[dict, dict]:
    """A 30 s request on the device engine (Separator's default on the card)
    for the dense model and the sparse, LSH and fast-preset sparse variants,
    each after a warm-up request (graphs captured), median of
    ``VARIANT_REPEATS``: audio-s/s, launches (K3 10 a forward on the sparse
    paths, none on the LSH path), one profiled request of the dense, the
    diag-sparse and the LSH model, peak memory above what was allocated
    before (over the warm-up request, which captures, and over the timed
    ones, which replay), the graphs' pool."""
    import numpy as np
    import torch

    from demucs_tpu_torch.api import Separator
    from demucs_tpu_torch.inference.engine import GRAPHS
    from demucs_tpu_torch.models.registry import Model
    from demucs_tpu_torch.presets import resolve_preset
    from demucs_tpu_torch.zoo.native import save_model

    wav = _track(30.0, 130)
    fast = resolve_preset("fast", "auto")[:2]
    runs = (("dense", "dense", None), ("sparse diag", "sparse diag", None),
            ("sparse diag_jmask_random", "sparse diag_jmask_random", None),
            ("lsh", "lsh", None), ("sparse diag fast", "sparse diag", fast))
    info, paths = {}, {}
    for label, variant, preset in runs:
        name = "htd_" + variant.replace(" ", "_").replace("=", "")
        if not (workdir / f"{name}.dmx").exists():
            module = models[variant]
            save_model(Model("htdemucs", module.cfg, module), workdir / f"{name}.dmx", half=False)
        kw = dict(compute_dtype=preset[0], matmul_precision=preset[1]) if preset else {}
        sep = Separator(name, repo=workdir, shifts=1, batch_size=16, **kw)
        counts = Counts(sep.model.module)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _stems(sep, wav)  # warm-up: captures the graphs
        torch.cuda.synchronize()
        capture_peak = torch.cuda.max_memory_allocated() - held
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        counts.zero()
        walls = []
        for _ in range(VARIANT_REPEATS):
            start = time.perf_counter()
            stems = _stems(sep, wav)
            walls.append(time.perf_counter() - start)
        run = counts.read()
        wall = sorted(walls)[len(walls) // 2]
        row = {"median_wall_s": wall, "wall_s": walls, "audio_s_per_s": 30.0 / wall,
               "launches": run["launches"], "expected": run["expected"],
               "graph_replays": run["graph_replays"], "eager_forwards": run["eager_forwards"],
               # a replay writes its activations into the graphs' pool unseen by
               # the allocator: the warm-up request, which captures, shows them
               "capture_request_peak_GiB": capture_peak / 2**30,
               "request_peak_GiB": (torch.cuda.max_memory_allocated() - held) / 2**30,
               "pool_GiB": (GRAPHS.pool_bytes() or 0) / 2**30,
               "finite": bool(all(np.isfinite(s).all() for s in stems))}
        if label in ("dense", "sparse diag", "lsh"):
            row["profile"] = profile_request(sep, wav)
        route = "flash_mha_bf16" if preset else "flash_mha"
        k3 = run["launches"][route]
        row["k3_per_forward"] = k3 / max(1, run["graph_replays"] + run["eager_forwards"])
        row["ok"] = (run["ok"] and row["finite"] and run["eager_forwards"] == 0
                     and (k3 == 0 if variant == "lsh" else k3 > 0))
        info[label] = row
        paths[f"htdemucs {label}"] = run["launches"]
        del sep, counts
        torch.cuda.empty_cache()
    return info, paths


def phase_variants(workdir: Path) -> tp.Tuple[dict, dict]:
    """The released-width HTDemucs with each remaining option (VARIANTS), one
    7.8 s segment on the card against the CPU (2e-4 x peak; the LSH variant
    by lsh_checks instead), then the 30 s requests (variant_requests)."""
    import torch

    info = {"phase": "variants", "card": card_line(), "tol": MODEL_RTOL, "forward": {}}
    models = {"dense": variant_model({})}
    for name, kw in VARIANTS.items():
        cpu_model = variant_model(kw)
        if name == "lsh":
            row = lsh_checks(cpu_model)
        else:
            row = card_vs_cpu(cpu_model, 7.8)
        info["forward"][name] = row
        if name in ("sparse diag", "sparse diag_jmask_random", "lsh"):
            models[name] = cpu_model
        torch.cuda.empty_cache()
    info["requests"], paths = variant_requests(workdir, models)
    info["ok"] = (all(r["ok"] for r in info["forward"].values())
                  and all(r["ok"] for r in info["requests"].values()))
    emit(info)
    if not info["ok"]:
        raise AssertionError("variants: a forward, a route or a launch count is wrong")
    return info, paths


HEAD_DIM_REPEATS = 3  # each 30 s request of the head_dims phase, median reported
HEADS4_TRAIN_STEPS = 4  # the head_dims phase's training steps a path (3-4 timed)


def k3_d128_train_checks(gen) -> list:
    """K3's D = 128 training instances at the transformer's four shapes
    (freq and time self, both cross directions; 4 heads of 128 channels),
    B = 1 and 8, both routes, unmasked and under the diag mask that SPARSE
    gives the shape, at dropout 0 and TRAIN_DROPOUT: the forward with each
    row's log-sum-exp against the plain version (fp32 K3_ATOL for both; bf16
    2^-6 abs + rel, its log-sum-exp K3_BF16_LSE_ATOL), dQ, dK, dV of the
    backward against the plain formula (K3_BWD_RTOL, K3_BF16_BWD_RTOL x each
    gradient's peak), by default and twice under deterministic() (bit-equal,
    each within tolerance). Times at freq self (2688 x 2688, B = 1 and 8):
    the backward at 0 and TRAIN_DROPOUT and under the flag, the plain
    backward (B = 1), SDPA's backward on the same shape (and mask); the
    dropout forwards beside the plain one and SDPA's with its dropout; the
    bound (the function's least work: bf16 5 x 2 B H Tq Tk d over 989
    TFLOP/s, fp32 three times that over 495; masked, the kept scores; bytes
    of q, k, v, o, dO, lse in and dQ, dK, dV out, and the mask as bits).
    Registers and spills of every D = 128 backward instance (none may
    spill). Returns the kernels line's rows of the new instances."""
    import torch
    import torch.nn.functional as F

    from demucs_tpu_torch.kernels import attention as KA
    from demucs_tpu_torch.ops.sparse import keep_mask

    H, d, T = HEAD_DIM_HEADS, 128, 2688
    C = H * d
    tokens = {"freq": T, "time": 1344}
    cases, timed, bad = {}, {}, []

    def times(route, batch, q, k, v, do, mask, tiles) -> dict:  # at freq self
        bwd = KA.flash_mha_bwd_bf16 if route == "bf16" else KA.flash_mha_bwd
        fwd = KA._forward_bf16 if route == "bf16" else KA._forward_f32
        size = 2 if route == "bf16" else 4
        o, lse = fwd(q, k, v, H, tiles, 0.0, 0, True)
        scores = T * T if mask is None else int(mask.bool().sum().item())
        flops = 5 * 2 * batch * H * scores * d
        # q, k, v, o, dO in and dQ, dK, dV out, lse; the mask as bits
        bits = 0 if mask is None else T * T // 8
        nbytes = size * batch * 8 * T * C + 4 * batch * H * T + bits
        b_ms, b_by = (bound(flops, nbytes, BF16_FLOPS) if route == "bf16"
                      else bound(3 * flops, nbytes, TF32_FLOPS))
        split = [t.view(batch, T, H, d).transpose(1, 2).detach().clone()
                 .requires_grad_() for t in (q, k, v)]
        keep = None if mask is None else mask.bool()
        so = F.scaled_dot_product_attention(*split, attn_mask=keep)
        so_drop = F.scaled_dot_product_attention(*split, attn_mask=keep,
                                                 dropout_p=TRAIN_DROPOUT)
        sdo = do.view(batch, T, H, d).transpose(1, 2)
        row = dict(
            ms=cuda_ms(lambda: bwd(q, k, v, o, do, H, lse=lse, mask=mask)),
            ms_dropout=cuda_ms(lambda: bwd(q, k, v, o, do, H, lse=lse, mask=mask,
                                           dropout=TRAIN_DROPOUT, dropout_seed=5)),
            deterministic_ms=_deterministic_ms(
                lambda: bwd(q, k, v, o, do, H, lse=lse, mask=mask)),
            sdpa_bwd_ms=cuda_ms(lambda: torch.autograd.grad(so, split, sdo,
                                                            retain_graph=True)),
            sdpa_bwd_ms_dropout=cuda_ms(lambda: torch.autograd.grad(
                so_drop, split, sdo, retain_graph=True)),
            fwd_ms_dropout=cuda_ms(lambda: fwd(q, k, v, H, tiles, TRAIN_DROPOUT, 5, False)),
            fwd_bound_ms=(bound(4 * batch * H * scores * d,
                                size * batch * 4 * T * C + bits, BF16_FLOPS)
                          if route == "bf16" else
                          bound(3 * 4 * batch * H * scores * d,
                                size * batch * 4 * T * C + bits, TF32_FLOPS))[0],
            bound_ms=b_ms, bound_by=b_by)
        with torch.no_grad():  # SDPA with the mask and its dropout, no graph
            row["sdpa_fwd_ms_dropout"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                *split, attn_mask=keep, dropout_p=TRAIN_DROPOUT))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        if batch == 1:
            row["plain_ms"] = cuda_ms(lambda: KA.flash_mha_bwd_plain(
                q, k, v, o, do, H, mask=mask), repeat=3)
            row["fwd_plain_ms_dropout"] = cuda_ms(lambda: KA.flash_mha_plain(
                q, k, v, H, mask=mask, dropout=TRAIN_DROPOUT, dropout_seed=5), repeat=3)
        return row

    for route, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        bwd = KA.flash_mha_bwd_bf16 if route == "bf16" else KA.flash_mha_bwd
        fwd = KA._forward_bf16 if route == "bf16" else KA._forward_f32
        tol = K3_BF16_BWD_RTOL if route == "bf16" else K3_BWD_RTOL
        for batch in (1, 8):
            for tq_name, tk_name in (("freq", "freq"), ("time", "time"), ("freq", "time"),
                                     ("time", "freq")):
                Tq, Tk = tokens[tq_name], tokens[tk_name]
                q, k, v, do = (torch.randn(batch, n, C, device="cuda", generator=gen).to(dtype)
                               for n in (Tq, Tk, Tk, Tq))
                # the mask SPARSE gives this shape's self or cross layers
                diag = keep_mask(Tq, Tk, "diag", device="cuda", **MASK_DEFAULTS)
                for masked in (False, True):
                    mask = diag if masked else None
                    tiles = None if mask is None else KA.mask_tiles(mask)
                    shape = f"{route} B={batch} {tq_name}<-{tk_name}"
                    name = shape + (" diag" if masked else "")
                    for rate in (0.0, TRAIN_DROPOUT):
                        o, lse = fwd(q, k, v, H, tiles, rate, 7, True)
                        want_o = KA.flash_mha_plain(q, k, v, H, mask=mask, dropout=rate,
                                                    dropout_seed=7)
                        want = KA.flash_mha_bwd_plain(q, k, v, want_o, do, H, mask=mask,
                                                      dropout=rate, dropout_seed=7)
                        got = bwd(q, k, v, o, do, H, lse=lse, mask=mask, dropout=rate,
                                  dropout_seed=7)
                        with deterministic():
                            det = [bwd(q, k, v, o, do, H, lse=lse, mask=mask, dropout=rate,
                                       dropout_seed=7) for _ in range(2)]
                        case = {
                            # bf16: the excess over its tolerance (<= 0 passes)
                            "fwd_err": (bf16_excess(o, want_o) if route == "bf16"
                                        else fp32_err(o, want_o)),
                            "fwd_abs_err": fp32_err(o.float(), want_o.float()),
                            "lse_err": fp32_err(lse, _lse_plain(q, k, H, mask)),
                            "dq_dk_dv_err_over_peak": [_grad_err(g.float(), w.float())
                                                       for g, w in zip(got, want)],
                            "deterministic_err_over_peak": [_grad_err(g.float(), w.float())
                                                            for g, w in zip(det[0], want)],
                            "deterministic_bit_equal": all(bool(torch.equal(a, b))
                                                           for a, b in zip(*det))}
                        fwd_tol, lse_tol = ((0, K3_BF16_LSE_ATOL) if route == "bf16"
                                            else (K3_ATOL, K3_ATOL))
                        case["ok"] = (case["fwd_err"] <= fwd_tol and case["lse_err"] <= lse_tol
                                      and max(case["dq_dk_dv_err_over_peak"]) <= tol
                                      and max(case["deterministic_err_over_peak"]) <= tol
                                      and case["deterministic_bit_equal"])
                        cases[f"{name} rate={rate}"] = case
                        bad += [] if case["ok"] else [f"{name} rate={rate}"]
                        del got, det, want, want_o, o, lse
                    if tq_name == tk_name == "freq":
                        timed[f"{route} B={batch}" + (" diag" if masked else "")] = times(
                            route, batch, q, k, v, do, mask, tiles)
                del q, k, v, do, diag
                torch.cuda.empty_cache()
    instances = d128_bwd_instances()
    fwd_inst = {k: v for k, v in bf16_instances().items()
                if k.startswith("d=128") and "dropout" in k}
    if not _no_spills(instances) or not _no_spills(fwd_inst) or len(fwd_inst) != 2:
        bad.append(f"spills or missing instances: {instances}, {fwd_inst}")
    rows = []

    def errs(route, masked, key="dq_dk_dv_err_over_peak"):  # the worst over the row's cases
        return max(max(c[key]) for n, c in cases.items()
                   if n.startswith(route + " ") and (" diag " in n) == masked)

    def dropped(masked):  # the bf16 cases with the dropout
        return [(n, c) for n, c in cases.items() if n.startswith("bf16 ")
                and (" diag " in n) == masked and not n.endswith("rate=0.0")]

    for route in ("fp32", "bf16"):
        for masked in (False, True):
            suffix = " diag" if masked else ""
            b1, b8 = timed[f"{route} B=1{suffix}"], timed[f"{route} B=8{suffix}"]
            name = ("flash_mha_bwd_bf16" if route == "bf16" else "flash_mha_bwd") + " D=128" + (
                " masked" if masked else "")
            base = dict(
                source="demucs_tpu_torch/csrc/flash_mha_bwd_d128.cu" if not masked else
                "demucs_tpu_torch/csrc/flash_mha_bwd_masked_d128.cu",
                replaces="demucs_tpu/ops/pallas/attention.py:103 (the gradient of its function "
                         "at head dim 128, :117; the Pallas kernel has no backward, JAX trains "
                         "through XLA's dense attention)",
                library=f"autograd.grad of F.scaled_dot_product_attention ({route}"
                        f"{', same mask' if masked else ''})",
                plain_ms=b1["plain_ms"], bound_by=b1["bound_by"],
                tol=K3_BF16_BWD_RTOL if route == "bf16" else K3_BWD_RTOL,
                max_err_is="over each gradient's peak",
                shape=f"q, k, v (1, 2688, 512), 4 heads of 128 (freq self; also B = 8)"
                      f"{', diag mask' if masked else ''}; max_abs_err over the four shapes",
                instances={k: v for k, v in instances.items()
                           if k.startswith(route) and ("masked" in k) == masked})
            rows.append(dict(base, name=name, ms=b1["ms"], library_ms=b1["sdpa_bwd_ms"],
                             bound_ms=b1["bound_ms"], max_abs_err=errs(route, masked),
                             deterministic_ms=b1["deterministic_ms"],
                             deterministic_max_abs_err=errs(route, masked,
                                                            "deterministic_err_over_peak"),
                             batch_8=b8, batch_1=b1))
            if route == "bf16" and not masked:  # the ordered instance: a row of its own
                rows.append(dict(base, name=name + " deterministic", ms=b1["deterministic_ms"],
                                 library_ms=b1["sdpa_bwd_ms"], bound_ms=b1["bound_ms"],
                                 max_abs_err=errs(route, masked, "deterministic_err_over_peak"),
                                 deterministic_ms=b1["deterministic_ms"],
                                 deterministic_max_abs_err=errs(
                                     route, masked, "deterministic_err_over_peak"),
                                 batch_8_ms=b8["deterministic_ms"]))
            if route == "bf16":  # the dropout forward's instance
                rows.append(dict(
                    name="flash_mha_bf16 D=128" + (" masked" if masked else "") + " dropout",
                    source="demucs_tpu_torch/csrc/flash_mha_d128.cu",
                    replaces="demucs_tpu/ops/pallas/attention.py:103 (its hashed dropout, "
                             ":34, :73-84, at head dim 128)",
                    ms=b1["fwd_ms_dropout"], plain_ms=b1["fwd_plain_ms_dropout"],
                    library_ms=b1["sdpa_fwd_ms_dropout"],
                    library=f"F.scaled_dot_product_attention (bf16, dropout_p {TRAIN_DROPOUT}"
                            f"{', same mask' if masked else ''})",
                    bound_ms=b1["fwd_bound_ms"], bound_by="operations",
                    max_abs_err=max(c["fwd_abs_err"] for n, c in dropped(masked)),
                    excess_over_tol=max(c["fwd_err"] for n, c in dropped(masked)),
                    tol=f"{K3_BF16_TOL} abs + rel",
                    batch_8_ms=b8["fwd_ms_dropout"],
                    instances={k: v for k, v in fwd_inst.items() if ("masked" in k) == masked},
                    shape="q, k, v (1, 2688, 512), 4 heads of 128, dropout 0.1 (freq self; "
                          f"also B = 8){', diag mask' if masked else ''}; max_abs_err over "
                          "the four shapes"))
    emit({"phase": "head_dim_train_kernels", "card": card_line(), "cases": cases,
          "times": timed, "instances": instances, "fwd_dropout_instances": fwd_inst,
          "ok": not bad})
    if bad:
        raise AssertionError(f"K3's D = 128 training instances: {bad}")
    return rows


def head_dims_training() -> tp.Tuple[dict, dict]:
    """HTDemucs at the released shape with t_heads=4 (K3's D = 128 backward)
    in training, dense and sparse (SPARSE): train_card_vs_cpu's card step
    against the CPU's at batch 1 on TRAIN_CHECK_LOSS (once by default, twice
    under deterministic(): bit-equal, each held to the CPU's), and
    train_bf16_card_vs_cpu's bf16 step of the same model and batch against
    the CPU's bf16 step (once by default, twice under deterministic():
    bit-equal, the ordered bf16 D = 128 instance); then HEADS4_TRAIN_STEPS
    steps at TRAIN_BATCH (4 if 8 does not fit) in fp32 and bf16, dense and
    sparse, at t_dropout TRAIN_DROPOUT (the D = 128 dropout instances), with
    audio-s/s. Every launch counted from 0 on each path: K3's D = 128
    backward instance of the path must be all of its route's backwards."""
    info, paths = {}, {}
    for form, kw in (("", {}), ("sparse ", SPARSE)):
        masked = " masked" if kw else ""
        _zero_train_counts()
        info[f"{form}card_vs_cpu_step"], step = train_card_vs_cpu(t_heads=4, **kw)
        steps = paths[f"htdemucs heads4 train {form}card steps"] = _read_train_counts()
        info[f"{form}bf16_card_vs_cpu_step"], det = train_bf16_card_vs_cpu(step)
        paths[f"htdemucs heads4 train {form}bf16 deterministic"] = det
        del step
        row = info[f"{form}card_vs_cpu_step"]
        row["ok"] = (row["ok"] and steps[f"flash_mha_bwd D=128{masked}"] > 0
                     and steps[f"flash_mha_bwd D=128{masked} deterministic"] > 0)
        row = info[f"{form}bf16_card_vs_cpu_step"]
        row["ok"] = (row["ok"] and det[f"flash_mha_bwd_bf16 D=128{masked} deterministic"]
                     == det["flash_mha_bwd_bf16"])
    for name, dtype, kw in (("fp32", "float32", {}), ("bf16", "bfloat16", {}),
                            ("sparse", "float32", SPARSE), ("sparse bf16", "bfloat16", SPARSE)):
        run, counts = train_throughput(dtype, steps=HEADS4_TRAIN_STEPS, detail=False, t_heads=4,
                                       t_dropout=TRAIN_DROPOUT, **kw)
        route = "flash_mha_bwd_bf16" if dtype == "bfloat16" else "flash_mha_bwd"
        instance = f"{route} D=128" + (" masked" if kw else "")
        run["ok"] = run["ok"] and counts[instance] == counts[route] > 0
        info[f"throughput {name}"] = run
        paths[f"htdemucs heads4 train {name}"] = counts
    return info, paths


def phase_head_dims(workdir: Path) -> tp.Tuple[list, dict]:
    """HTDemucs at the released shape with t_heads=4 (512 channels in 4
    heads: head dim 128, K3's D = 128 instances) through Separator on a 30 s
    track in four forms: fp32 (K3's fp32 route), the fast preset (its bf16
    route), and sparse self- and cross-attention at the reference's defaults
    (the masked instances) in fp32 and on the fast preset. Per form: one 7.8
    s segment on the card against a CPU copy (2e-4 x peak; on the fast
    preset instead the SER of its stems against the fp32 form's on the same
    weights, PRESET_SER_DB), a warm-up request (graphs captured),
    then HEAD_DIM_REPEATS requests on the device engine with every launch
    counted: K3's launches of the D = 128 instance of the form (masked on
    the sparse form) must be all of K3's and more than 0; the wall time.
    Then the same model in training: K3's D = 128 training instances alone
    (k3_d128_train_checks) and its train steps (head_dims_training).
    Returns the D = 128 training instances' rows of the kernels line and the
    launches of each path."""
    import numpy as np
    import torch

    from demucs_tpu_torch.api import Separator
    from demucs_tpu_torch.inference.engine import GRAPHS
    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs
    from demucs_tpu_torch.models.registry import Model
    from demucs_tpu_torch.presets import resolve_preset
    from demucs_tpu_torch.zoo.native import save_model

    shape = dict(RELEASED, t_heads=4)
    wav = _track(30.0, 140)
    fast = resolve_preset("fast", "auto")[:2]
    info = {"phase": "head_dims", "card": card_line(), "model": shape, "tol": MODEL_RTOL,
            "forms": {}}
    paths, ref = {}, {}
    for form, kw, preset in (("fp32", {}, None), ("fast", {}, fast), ("sparse", SPARSE, None),
                             ("sparse fast", SPARSE, fast)):
        name = "htd_heads4_sparse" if kw else "htd_heads4"
        row = {}
        if preset is None:
            cfg = HTDemucsConfig(segment=7.8, **shape, **kw)
            cpu_model = init_htdemucs(cfg, seed=6, layer_scale=1.0, random_norms=True).eval()
            row["card_vs_cpu"] = card_vs_cpu(cpu_model, 7.8)
            save_model(Model("htdemucs", cfg, cpu_model), workdir / f"{name}.dmx", half=False)
            del cpu_model
        extra = dict(compute_dtype=preset[0], matmul_precision=preset[1]) if preset else {}
        sep = Separator(name, repo=workdir, shifts=1, batch_size=16, **extra)
        counts = Counts(sep.model.module)
        _stems(sep, wav)  # warm-up: captures the graphs
        counts.zero()
        walls = []
        for _ in range(HEAD_DIM_REPEATS):
            start = time.perf_counter()
            stems = _stems(sep, wav)
            walls.append(time.perf_counter() - start)
        run = counts.read()
        wall = sorted(walls)[len(walls) // 2]
        route = "flash_mha_bf16" if preset else "flash_mha"
        instance = f"{route} D=128" + (" masked" if kw else "")
        launched = run["launches"]
        row.update(launches=launched, expected=run["expected"], instance=instance,
                   instance_launches=launched[instance], median_wall_s=wall, wall_s=walls,
                   audio_s_per_s=30.0 / wall, graph_replays=run["graph_replays"],
                   finite=bool(np.isfinite(stems).all()))
        if preset is None:
            ref[name] = stems
            checked = row["card_vs_cpu"]["ok"]
        else:  # the fast preset against the fp32 form of the same weights
            row["ser_db_vs_fp32"] = _ser_db(ref[name], stems)
            row["ser_bound_db"] = PRESET_SER_DB["fast"]
            checked = row["ser_db_vs_fp32"] == "bit-equal" or row["ser_db_vs_fp32"] >= \
                PRESET_SER_DB["fast"]
        row["ok"] = (run["ok"] and checked and row["finite"]
                     and launched[instance] == launched[route] > 0)
        info["forms"][form] = row
        paths[f"htdemucs heads4 {form}"] = launched
        del sep, counts
        torch.cuda.empty_cache()
    GRAPHS.clear()
    torch.cuda.empty_cache()
    with _fp32():
        rows = k3_d128_train_checks(torch.Generator(device="cuda").manual_seed(12))
        info["train"], train_paths = head_dims_training()
    paths.update(train_paths)
    # each D = 128 training instance launched on the paths above
    info["train_instance_launches"] = {r["name"]: sum(c.get(r["name"], 0) for c in paths.values())
                                       for r in rows}
    info["ok"] = (all(r["ok"] for r in info["forms"].values())
                  and all(r["ok"] for r in info["train"].values())
                  and all(info["train_instance_launches"].values()))
    emit(info)
    if not info["ok"]:
        raise AssertionError("head_dims: a form's launches, card vs CPU or SER, or a train "
                         "step is wrong")
    return rows, paths


def phase_memory(workdir: Path) -> dict:
    """pass_memory_analysis for a 30 s request of the served HTDemucs (the
    JAX engine's report, here from a run of the pass) against what the same
    request measures: cold (the graphs captured inside it, so every
    activation passes through the allocator) and warm (the allocator's peak
    above what was held before, plus the graphs' pool, which replays write
    without the allocator). Then the pool all earlier phases filled, before
    and after GRAPHS.clear() + torch.cuda.empty_cache(), and a request after
    it: it captures its graphs again and gives the same stems."""
    import random

    import numpy as np
    import torch

    from demucs_tpu_torch.api import Separator
    from demucs_tpu_torch.inference.engine import GRAPHS, pass_memory_analysis

    gib = 2**30
    sep = Separator("htdemucs_smoke", repo=workdir, shifts=1, batch_size=16)
    model = sep.model
    weights = sum(p.numel() * p.element_size() for p in model.module.parameters())
    wav = _track(30.0, 140)
    sep.separate_tensor(wav, SR)  # warm-up: captures this model's graphs
    start = time.perf_counter()
    mem = pass_memory_analysis(model, wav.shape[-1], shifts=1)
    analysis_s = time.perf_counter() - start
    random.seed(5)
    _, stems = sep.separate_tensor(wav, SR)
    torch.cuda.synchronize()
    pool_before = GRAPHS.pool_bytes() or 0
    graphs_before = len(GRAPHS.entries)
    reserved_before = torch.cuda.memory_reserved()
    GRAPHS.clear()
    torch.cuda.empty_cache()
    reserved_after = torch.cuda.memory_reserved()
    allocated_after = torch.cuda.memory_allocated()
    pool_after = GRAPHS.pool_bytes()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    captures = GRAPHS.captures
    random.seed(5)
    _, again = sep.separate_tensor(wav, SR)  # cold: its graphs captured again inside it
    torch.cuda.synchronize()
    cold = torch.cuda.max_memory_allocated() - held + weights
    recaptured = GRAPHS.captures - captures
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    random.seed(5)
    sep.separate_tensor(wav, SR)  # warm: the pool now holds this request's graphs only
    torch.cuda.synchronize()
    warm = torch.cuda.max_memory_allocated() - held + weights + (GRAPHS.pool_bytes() or 0)
    same = all(np.array_equal(stems[k], again[k]) for k in stems)
    info = {"phase": "memory", "card": card_line(), "seconds": 30.0,
            "pass_memory_analysis": mem, "analysis_s": analysis_s,
            "measured_cold_GiB": cold / gib, "measured_warm_GiB": warm / gib,
            "estimate_over_cold": mem["peak_estimate_gb"] * gib / cold,
            "estimate_over_warm": mem["peak_estimate_gb"] * gib / warm,
            "pool_before_clear_GiB": pool_before / gib, "graphs_before_clear": graphs_before,
            "pool_after_clear_GiB": (pool_after or 0) / gib,
            "reserved_before_clear_GiB": reserved_before / gib,
            "reserved_after_clear_GiB": reserved_after / gib,
            "allocated_after_clear_GiB": allocated_after / gib,
            "recaptured": recaptured, "stems_equal_after_clear": same}
    info["ok"] = (mem is not None and pool_after == 0 and recaptured > 0 and same
                  and reserved_before - reserved_after >= pool_before
                  and mem["peak_estimate_gb"] > 0)
    emit(info)
    if not info["ok"]:
        raise AssertionError(f"memory: {info}")
    return info


def _musdb_folder(root: Path, tracks: int, seconds: float) -> Path:
    """A MusdbHQ-shaped folder of synthetic tracks: each stem a few tones and
    noise from a seed, the mixture their sum, 16-bit WAVs at 44.1 kHz."""
    import numpy as np

    from demucs_tpu_torch.audio import write_wav

    sources = ("drums", "bass", "other", "vocals")
    t = np.arange(int(seconds * SR)) / SR
    for i in range(tracks):
        folder = root / "test" / f"Synthetic {i}"
        folder.mkdir(parents=True)
        rng = np.random.default_rng(200 + i)
        stems = []
        for j, _ in enumerate(sources):
            tone = 0.15 * np.sin(2 * np.pi * 55.0 * (j + 1) * (i + 1) * t + j)
            stems.append(np.stack([tone, 0.8 * tone]) + 0.02 * rng.standard_normal((2, t.size)))
        for name, wav in zip(sources, stems):
            write_wav(folder / f"{name}.wav", wav.astype(np.float32), SR)
        write_wav(folder / "mixture.wav", np.sum(stems, axis=0).astype(np.float32), SR)
    return root


def phase_evaluate(workdir: Path) -> dict:
    """evaluate(compute_sdr=True) on the card (the served HTDemucs, shifts 0,
    workers 0, museval where installed, else the port's bss_eval_images) over
    a synthetic 1-track x 10 s MusdbHQ folder: each track's nsdr against
    eval_track on Separator's stems for that track (EVAL_NSDR_TOL; Separator
    normalizes by std + 1e-8, evaluate by std), seconds per track for the
    separation on the card and for BSS-eval on the host."""
    import types

    import numpy as np

    from demucs_tpu_torch import evaluate as ev
    from demucs_tpu_torch.api import Separator
    from demucs_tpu_torch.audio import read_wav
    from demucs_tpu_torch.run_sdr import eval_args

    musdb = _musdb_folder(workdir / "musdbhq", EVAL_TRACKS, EVAL_SECONDS)
    sep = Separator("htdemucs_smoke", repo=workdir, shifts=0, batch_size=16)
    seen, eval_s = [], []
    real = ev.eval_track

    def recorded(references, estimates, **kw):
        start = time.perf_counter()
        scores = real(references, estimates, **kw)
        eval_s.append(time.perf_counter() - start)
        seen.append(scores[1])
        return scores

    solver = types.SimpleNamespace(args=eval_args(musdb, shifts=0, workers=0), model=sep.model,
                                   folder=workdir / "eval")
    ev.eval_track = recorded
    try:
        start = time.perf_counter()
        result = ev.evaluate(solver, compute_sdr=True)
        wall = time.perf_counter() - start
    finally:
        ev.eval_track = real
    per_track, sep_s = [], []
    for i, track in enumerate(sorted((musdb / "test").iterdir())):
        mix, _ = read_wav(track / "mixture.wav")
        start = time.perf_counter()
        _, stems = sep.separate_tensor(mix)
        sep_s.append(time.perf_counter() - start)
        refs = np.stack([read_wav(track / f"{s}.wav")[0] for s in sep.model.sources])
        want = real(refs, np.stack([stems[s] for s in sep.model.sources]), win=SR, hop=SR,
                    compute_sdr=False)[1]
        per_track.append(float(np.abs(seen[i] - want).max()))
    info = {"phase": "evaluate", "card": card_line(), "tracks": EVAL_TRACKS,
            "seconds_each": EVAL_SECONDS,
            "bss_eval": "museval" if _has_museval() else "demucs_tpu_torch.ops.bsseval",
            "scores": result, "evaluate_wall_s": wall, "bss_eval_s_per_track": eval_s,
            "separation_s_per_track": sep_s, "nsdr_vs_separator_db": per_track,
            "tol_db": EVAL_NSDR_TOL}
    info["ok"] = (len(seen) == EVAL_TRACKS and max(per_track) <= EVAL_NSDR_TOL
                  and all(np.isfinite(result[k]) for k in ("nsdr", "sdr", "sdr_med")))
    emit(info)
    if not info["ok"]:
        raise AssertionError(f"evaluate: {info}")
    return info


# ---------------------------------------------------------------------------
# Training: K3's dropout and backward kernel, K2's backward (K1's kernel),
# the card's train step against the CPU's, the training rate, the entry point
# ---------------------------------------------------------------------------

TRAIN_DROPOUT = 0.1  # K3's dropout checks and the entry point's t_dropout
K3_BWD_RTOL = 1e-4  # K3's backward: each gradient's max error over its peak
TRAIN_RTOL = 2e-4  # card vs CPU train step: loss, reco, the gradient's global norm, x peak
# card vs CPU, each gradient: TRAIN_GRAD_RTOL x its own peak plus TRAIN_GRAD_FLOOR x the
# largest gradient's peak (a bias before a norm has a zero true gradient), on the mse loss:
# l1's gradient is the sign of each residual, and the few residuals within the devices'
# fp32 differences of zero flip between them (C2, train_c2_probe)
TRAIN_CHECK_LOSS = "mse"
TRAIN_GRAD_RTOL = 2e-4
TRAIN_GRAD_FLOOR = 1e-5
TRAIN_BATCH = 8  # the throughput loop's batch (4 where 8 does not fit)
TRAIN_STEPS = 6  # steps 3-6 timed
SPARSE_TRAIN_STEPS = 4  # the sparse training paths' steps (3-4 timed)
TRAIN_SEGMENT = 7.8  # the released HTDemucs's training segment, seconds
ENTRY_BATCH = 4  # the entry point's batch (the remix augment's group size)
TRAIN_KERNELS = ("stft_dft", "istft_dft", "flash_mha", "flash_mha_bwd", "istft_dft_backward",
                 "stft_dft_backward")
# the bf16 training path (compute_dtype="bfloat16"): K3 on its bf16 route, forward and backward
TRAIN_BF16_KERNELS = ("stft_dft", "istft_dft", "flash_mha_bf16", "flash_mha_bwd_bf16",
                      "istft_dft_backward")
# K3's bf16 backward: each gradient's max error over its peak. bf16 outputs (2^-9
# relative), and Z P and dS rounded to bf16 for their products: the CPU model of the
# kernel's arithmetic (tests/test_torch_attention_train.py) reads up to 6.7e-3 at
# these shapes
K3_BF16_BWD_RTOL = 2.0 ** -6
K3_BF16_LSE_ATOL = 1e-4  # the bf16 forward's base-2 log-sum-exp: fp32 sums of up to 2688 terms
# K3's backward, two launches on the same inputs: the blocks of keys add their parts of dQ with
# atomics in the order they finish, so dQ may differ by a few fp32 roundings of its sums (fp32
# route), or one bf16 step where those sums round to bf16 (bf16 route); x dQ's peak. dK and dV
# take no atomics: bit-equal (tests/test_torch_cuda.py test_flash_mha_backward_launches_agree)
K3_BWD_RERUN_RTOL = 1e-5
K3_BF16_BWD_RERUN_RTOL = 2.0 ** -8
# bf16 train step, card vs CPU (tests/test_torch_train.py's CPU anchor against JAX): loss
# and reco relative, the global norm relative; each gradient within twice the CPU's own gap
# between its bf16 and fp32 steps plus this share of the largest gradient's peak
TRAIN_BF16_RTOL = 1e-3
TRAIN_BF16_NORM_RTOL = 1e-2
TRAIN_BF16_GRAD_FLOOR = 2e-3
# C2: the card alone is far off where a gradient (of a tensor whose true peak is at least
# C2_PEAK_SHARE of the largest) is off the float64 truth by more than C2_RATIO times the
# CPU's error and by more than C2_FLOOR of its own peak
C2_PEAK_SHARE = 1e-3
C2_RATIO = 10.0
C2_FLOOR = 1e-4


def _train_counters():
    """name -> (wrapper, its count's attribute): each kernel's launches, and
    K3's backward launches under a mask on each route (the masked instances,
    rows of their own in the kernels line); then (a route's
    ``launches_by_instance``, its key) for K3's D = 128 instances, forward
    and backward ("flash_mha_bwd D=128 masked deterministic")."""
    from demucs_tpu_torch.kernels import attention as KA
    from demucs_tpu_torch.kernels import stft as KS

    counters = {name: (fn, "launches") for name, fn in (
        ("stft_dft", KS.stft_dft), ("istft_dft", KS.istft_dft), ("flash_mha", KA.flash_mha),
        ("flash_mha_bwd", KA.flash_mha_bwd), ("istft_dft_backward", KS.istft_dft_backward),
        ("stft_dft_backward", KS.stft_dft_backward), ("flash_mha_bf16", KA.flash_mha_bf16),
        ("flash_mha_bwd_bf16", KA.flash_mha_bwd_bf16))}
    counters["flash_mha_bwd masked"] = (KA.flash_mha_bwd, "masked_launches")
    counters["flash_mha_bwd_bf16 masked"] = (KA.flash_mha_bwd_bf16, "masked_launches")
    for fn in (KA.flash_mha, KA.flash_mha_bf16, KA.flash_mha_bwd, KA.flash_mha_bwd_bf16):
        for key in fn.launches_by_instance:
            if key.startswith("D=128"):
                counters[f"{fn.__name__} {key}"] = (fn.launches_by_instance, key)
    return counters


def _zero_train_counts() -> None:
    for obj, attr in _train_counters().values():
        if isinstance(obj, dict):
            obj[attr] = 0
        else:
            setattr(obj, attr, 0)


def _read_train_counts() -> dict:
    return {name: obj[attr] if isinstance(obj, dict) else getattr(obj, attr)
            for name, (obj, attr) in _train_counters().items()}


def _grad_err(got, want) -> float:
    """Max |got - want| over want's peak."""
    return ((got - want).abs().max() / want.abs().max()).item()


def _rerun_gap(backward, q, k, v, o, do, num_heads: int, lse) -> dict:
    """Two launches of a backward kernel on the same inputs (dropout 0.1):
    dQ's largest difference over its peak, and whether dK and dV are equal;
    then two launches under deterministic(): whether dQ, dK and dV are all
    equal (C5)."""
    import torch

    def twice():
        return [backward(q, k, v, o, do, num_heads, lse=lse, dropout=TRAIN_DROPOUT,
                         dropout_seed=5) for _ in range(2)]

    first, second = twice()
    dq1, dq2 = first[0].float(), second[0].float()
    with deterministic():
        ordered = twice()
    return {"dq_gap_over_peak": ((dq1 - dq2).abs().max() / dq1.abs().max()).item(),
            "dk_dv_equal": bool(torch.equal(first[1], second[1])
                                and torch.equal(first[2], second[2])),
            "deterministic_equal": all(bool(torch.equal(a, b)) for a, b in zip(*ordered))}


def _deterministic_ms(fn) -> float:
    with deterministic():
        return cuda_ms(fn)


def bwd_instances(route: str, report: tp.Optional[str] = None, masked: bool = False) -> dict:
    """Registers and spills of each block-kernel instance of K3's backward on
    ``route`` ("Bf16Bwd" or "F32Bwd") at head dims 32, 48 and 64, the default
    and the deterministic order's ("ordered"), from nvcc's report of the
    library (the masked instances' with ``masked``), or of ``report``."""
    from demucs_tpu_torch.kernels import _build

    groups = r"ILi(\d+)ELi(\d+)ELb([01])E" if route == "Bf16Bwd" else r"ILi(\d+)ELb([01])E"
    if report is None:
        report = _build.ptxas_report("flash_mha_bwd_masked" if masked else "flash_mha_bwd")
    found = ptxas_kernels(report, rf"bwd_kernelINS_\d+{route}{groups}")
    named = {}
    for key, v in found.items():
        d, *nwg, ordered = key.split()
        if d == "128":  # the D = 128 instances: d128_bwd_instances
            continue
        named[f"d={d}" + (f" keys={64 * int(nwg[0])}" if nwg else "")
              + (" ordered" if ordered == "1" else "")] = v
    if len(named) != 2 * 3 * (2 if route == "Bf16Bwd" else 1) or not all(
            {"registers_at_launch", "spill_stores", "spill_loads"} <= set(v)
            for v in named.values()):
        raise AssertionError(f"K3 backward: nvcc's report lacks {route} instances: {named}")
    return named


def d128_bwd_instances() -> dict:
    """Registers and spills of K3's backward instances at head dim 128, from
    nvcc's reports of both backward libraries (csrc/flash_mha_bwd_d128.cu and
    its masked twin): the bf16 route's block kernel (Bf16Bwd<128, 1, ORDERED,
    MASKED>) and the fp32 route's dK / dV and dQ kernels."""
    from demucs_tpu_torch.kernels import _build
    from demucs_tpu_torch.kernels import attention as KA

    KA._bwd_lib(), KA._bwd_masked_lib()
    named = {}
    for lib, tag in (("flash_mha_bwd", ""), ("flash_mha_bwd_masked", " masked")):
        report = _build.ptxas_report(lib)
        for key, v in ptxas_kernels(report, r"bwd_kernelINS_\d+Bf16BwdILi128ELi1ELb([01])E"
                                    ).items():
            named["bf16 block" + tag + (" ordered" if key == "1" else "")] = v
        for key, v in ptxas_kernels(report, r"bwd_(dkdv|dq)_f32_d128I").items():
            named[f"fp32 {key}" + tag] = v
    if len(named) != 8 or not all({"registers_at_launch", "spill_stores", "spill_loads"}
                                  <= set(v) for v in named.values()):
        raise AssertionError(f"K3 backward D = 128: nvcc's report lacks instances: {named}")
    return named


def _no_spills(instances: dict) -> bool:
    return all(v["spill_stores"] == v["spill_loads"] == 0 for v in instances.values())


def train_k3_checks(gen) -> dict:
    """K3 forward with dropout and K3's backward kernel at the transformer's four
    shapes, B = 1 and 8, unmasked and under the diag mask, at dropout 0 and
    TRAIN_DROPOUT: the forward against the plain version with the same seed
    (K3_ATOL), dQ, dK, dV against the plain backward formula (K3_BWD_RTOL x
    each gradient's peak), by default and under deterministic() (the ordered
    instances); two launches on the same inputs (K3_BWD_RERUN_RTOL), the
    deterministic launch's plan as it reports it (the CPU twin must agree)
    and nvcc's report of the kernel's instances (no spills). Times the
    backward kernel (unmasked, dropout 0 and TRAIN_DROPOUT), the plain
    backward and SDPA's fp32 backward."""
    import torch
    import torch.nn.functional as F

    from demucs_tpu_torch.kernels import attention as KA
    from demucs_tpu_torch.ops.sparse import keep_mask

    dev = torch.device("cuda")
    C, H = 512, 8
    d = C // H
    tokens = {"freq": 2688, "time": 1344}
    cases, by_shape, rerun, worst_fwd, worst_bwd, worst_det = [], {}, {}, 0.0, 0.0, 0.0
    for batch in (1, 8):
        for tq_name, tk_name in (("freq", "freq"), ("time", "time"), ("freq", "time"),
                                 ("time", "freq")):
            Tq, Tk = tokens[tq_name], tokens[tk_name]
            q = torch.randn(batch, Tq, C, device=dev, generator=gen)
            k = torch.randn(batch, Tk, C, device=dev, generator=gen)
            v = torch.randn(batch, Tk, C, device=dev, generator=gen)
            do = torch.randn(batch, Tq, C, device=dev, generator=gen)
            key = f"B={batch} {tq_name}<-{tk_name}"
            for masked, rate in itertools.product((False, True), (0.0, TRAIN_DROPOUT)):
                mask = keep_mask(Tq, Tk, "diag", device=dev, **MASK_DEFAULTS) if masked else None
                seed = 1000 + len(cases)
                tiles = None if mask is None else KA.mask_tiles(mask)
                o, lse = KA._forward_f32(q, k, v, H, tiles, rate, seed, True)
                want_o = KA.flash_mha_plain(q, k, v, H, mask=mask, dropout=rate,
                                            dropout_seed=seed)
                got = KA.flash_mha_bwd(q, k, v, o, do, H, lse=lse, mask=mask, dropout=rate,
                                       dropout_seed=seed)
                want = KA.flash_mha_bwd_plain(q, k, v, want_o, do, H, mask=mask, dropout=rate,
                                              dropout_seed=seed)
                errs = [_grad_err(g, w) for g, w in zip(got, want)]
                with deterministic():  # the deterministic order's kernel, same inputs
                    got = KA.flash_mha_bwd(q, k, v, o, do, H, lse=lse, mask=mask, dropout=rate,
                                           dropout_seed=seed)
                det_errs = [_grad_err(g, w) for g, w in zip(got, want)]
                fwd = (o - want_o).abs().max().item()
                worst_fwd, worst_bwd = max(worst_fwd, fwd), max(worst_bwd, *errs)
                worst_det = max(worst_det, *det_errs)
                cases.append({"case": key, "mask": "diag" if masked else None, "dropout": rate,
                              "fwd_max_abs_err": fwd, "dq_dk_dv_err_over_peak": errs,
                              "deterministic_dq_dk_dv_err_over_peak": det_errs})
                del o, lse, want_o, got, want
            o, lse = KA._forward_f32(q, k, v, H, None, 0.0, 0, True)
            rerun[key] = _rerun_gap(KA.flash_mha_bwd, q, k, v, o, do, H, lse)
            flops = 5 * 2 * batch * H * Tq * Tk * d
            nbytes = 4 * (batch * (3 * Tq + 4 * Tk) * C + batch * H * Tq)
            b_ms, b_by = bound(3 * flops, nbytes, TF32_FLOPS)
            split = [t.view(batch, -1, H, d).transpose(1, 2).detach().clone().requires_grad_()
                     for t in (q, k, v)]
            so = F.scaled_dot_product_attention(*split)
            so_drop = F.scaled_dot_product_attention(*split, dropout_p=TRAIN_DROPOUT)
            sdo = do.view(batch, Tq, H, d).transpose(1, 2)
            row = dict(
                ms=cuda_ms(lambda: KA.flash_mha_bwd(q, k, v, o, do, H, lse=lse)),
                deterministic_ms=_deterministic_ms(
                    lambda: KA.flash_mha_bwd(q, k, v, o, do, H, lse=lse)),
                ms_dropout=cuda_ms(lambda: KA.flash_mha_bwd(
                    q, k, v, o, do, H, lse=lse, dropout=TRAIN_DROPOUT, dropout_seed=5)),
                fwd_ms=cuda_ms(lambda: KA.flash_mha(q, k, v, H)),
                fwd_ms_dropout=cuda_ms(lambda: KA.flash_mha(q, k, v, H, dropout=TRAIN_DROPOUT,
                                                            dropout_seed=5)),
                sdpa_bwd_ms=cuda_ms(lambda: torch.autograd.grad(so, split, sdo,
                                                                retain_graph=True)),
                sdpa_bwd_ms_dropout=cuda_ms(lambda: torch.autograd.grad(
                    so_drop, split, sdo, retain_graph=True)),
                sdpa_fwd_ms_dropout=cuda_ms(lambda: _sdpa_no_grad(split, TRAIN_DROPOUT)),
                bound_ms=b_ms, bound_by=b_by, fn_bound_ms=bound(flops, nbytes, TF32_FLOPS)[0],
                fwd_bound_ms=bound(3 * flops * 2 / 5, 4 * batch * (2 * Tq + 2 * Tk) * C,
                                   TF32_FLOPS)[0])
            row["dropout_over_bwd"] = row["ms_dropout"] / row["ms"] - 1
            row["deterministic_over_bwd"] = row["deterministic_ms"] / row["ms"] - 1
            # the deterministic launch's grid, order, rounds of heads and dQ ring, as it
            # reports them
            row["deterministic_plan"] = KA.bwd_plan(torch.float32, 64, batch, Tq, Tk, H, d)
            if tq_name == tk_name == "freq":
                row["plain_ms"] = cuda_ms(lambda: KA.flash_mha_bwd_plain(q, k, v, o, do, H),
                                          repeat=3)
            by_shape[key] = row
            del q, k, v, do, o, lse, split, so, so_drop
            torch.cuda.empty_cache()
    main = by_shape[f"B={TRAIN_BATCH} freq<-freq"]
    instances = bwd_instances("F32Bwd")
    rerun_ok = all(r["dq_gap_over_peak"] <= K3_BWD_RERUN_RTOL and r["dk_dv_equal"]
                   and r["deterministic_equal"] for r in rerun.values())
    plans_ok = all(r["deterministic_plan"]["twin_agrees"] for r in by_shape.values())
    return dict(
        name="flash_mha_bwd", tol=K3_BWD_RTOL, max_abs_err=worst_bwd,
        max_err_is="over each gradient's peak", fwd_dropout_max_abs_err=worst_fwd,
        deterministic_max_abs_err=worst_det,
        fwd_tol=K3_ATOL, within_tol=(worst_bwd <= K3_BWD_RTOL and worst_det <= K3_BWD_RTOL
                                     and worst_fwd <= K3_ATOL and rerun_ok and plans_ok
                                     and _no_spills(instances)),
        rerun=rerun, rerun_tol=K3_BWD_RERUN_RTOL, instances=instances,
        source="demucs_tpu_torch/csrc/flash_mha_bwd.cu",
        replaces="demucs_tpu/ops/pallas/attention.py:103 (the gradient of its function; the "
                 "Pallas kernel has no backward, JAX trains through XLA's dense attention)",
        ms=main["ms"], plain_ms=main["plain_ms"], library_ms=main["sdpa_bwd_ms"],
        deterministic_ms=main["deterministic_ms"],
        library="autograd.grad of F.scaled_dot_product_attention (fp32)",
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        bound_rule="max(3 x 5 x 2 B H Tq Tk d / 495 TFLOP/s (five products in 3xTF32), bytes "
                   "of q, k, v, o, dO, lse in and dQ, dK, dV out / 3.35 TB/s)",
        shape=f"q, k, v (B={TRAIN_BATCH}, 2688, 512), 8 heads (freq self)",
        by_shape=by_shape, cases=cases)


def _sdpa_no_grad(split, p: float = 0.0):
    """SDPA on the heads-split q, k, v without a graph, with dropout p."""
    import torch
    import torch.nn.functional as F

    with torch.no_grad():
        return F.scaled_dot_product_attention(*split, dropout_p=p)


def _lse_plain(q, k, num_heads: int, mask):
    """Each row's base-2 log-sum-exp of the scores scaled by log2(e)/sqrt(d),
    from the bf16 q and k in fp32 (B * H, Tq)."""
    import torch

    from demucs_tpu_torch.kernels import attention as KA

    B, Tq, C = q.shape
    d = C // num_heads
    s = torch.einsum("bqhd,bkhd->bhqk", q.float().view(B, Tq, num_heads, d),
                     k.float().view(B, -1, num_heads, d)) * KA.q_scale(d)
    if mask is not None:
        s = s.masked_fill(~mask.bool(), float("-inf"))
    return (torch.logsumexp(s * math.log(2), -1) / math.log(2)).reshape(B * num_heads, Tq)


def _drop_pattern_mismatches(q, k, num_heads: int, rate: float, seed: int, keep=None) -> int:
    """Scores the bf16 kernel drops other than ``dropout_keep``'s, over three
    windows of 64 keys (first, middle, last): with one-hot values on a window
    (key j of each head writes channel j of the head) the output there is Z P
    / l, zero exactly where a score was dropped. q and k are scaled by 0.3, so
    that no kept probability comes near underflow. ``keep``: dropout_keep's
    mask (B, H, Tq, Tk), when the caller has it."""
    import torch

    from demucs_tpu_torch.kernels import attention as KA
    from demucs_tpu_torch.ops.attention import dropout_keep

    B, Tq, C = q.shape
    Tk, d = k.shape[1], C // num_heads
    qs, ks = (0.3 * q.float()).bfloat16(), (0.3 * k.float()).bfloat16()
    if keep is None:
        keep = dropout_keep(B * num_heads, Tq, Tk, rate, seed,
                            q.device).view(B, num_heads, Tq, Tk)
    idx = torch.arange(d, device=q.device)
    bad = 0
    for start in (0, (Tk // 2 // d) * d, Tk - d):
        v = torch.zeros(B, Tk, C, device=q.device, dtype=torch.bfloat16)
        for h in range(num_heads):
            v[:, start + idx, h * d + idx] = 1
        out = KA.flash_mha_bf16(qs, ks, v, num_heads, dropout=rate, dropout_seed=seed)
        dropped = (out.view(B, Tq, num_heads, d) == 0).permute(0, 2, 1, 3)
        bad += (dropped != ~keep[..., start:start + d]).sum().item()
    return bad


def train_k3_bf16_checks(gen) -> dict:
    """K3's bf16 route as bf16 training runs it, at the transformer's four
    shapes, B = 1 and 8, unmasked and under the diag mask, at dropout 0 and
    TRAIN_DROPOUT: the forward with each row's log-sum-exp against the plain
    version (K3_BF16_TOL) and the plain scores' log-sum-exp
    (K3_BF16_LSE_ATOL); the drop pattern bit for bit against dropout_keep
    (_drop_pattern_mismatches), also on every plan (keys per tile x rows per
    block x the persistent schedule or a block per row block, forced) at
    TRAIN_DROPOUT, each timed and held to the plain version; dQ, dK, dV of the
    bf16 backward kernel against the plain formula (K3_BF16_BWD_RTOL x each
    gradient's peak) on the keys per block bwd_keys chooses and on both (64,
    128) unmasked, each by default and under deterministic() (the ordered
    instances); two launches on the same inputs (K3_BF16_BWD_RERUN_RTOL), the
    deterministic launch's plans as it reports them (the CPU twin must agree)
    and nvcc's report of the backward's instances and of the forward's
    dropout instances (none may spill). Times the backward kernel at both
    block sizes and the forward, each with and without dropout, beside SDPA
    in bf16 (forward and backward, each with and without its dropout), and
    the plain versions at freq self."""
    import torch
    import torch.nn.functional as F

    from demucs_tpu_torch.kernels import attention as KA
    from demucs_tpu_torch.ops.attention import dropout_keep
    from demucs_tpu_torch.ops.sparse import keep_mask

    dev = torch.device("cuda")
    C, H = 512, 8
    d = C // H
    tokens = {"freq": 2688, "time": 1344}
    cases, by_shape, rerun = [], {}, {}
    worst = {"fwd_excess": -math.inf, "lse": 0.0, "bwd": 0.0, "deterministic_bwd": 0.0,
             "pattern_mismatches": 0}
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for batch in (1, 8):
        for tq_name, tk_name in (("freq", "freq"), ("time", "time"), ("freq", "time"),
                                 ("time", "freq")):
            Tq, Tk = tokens[tq_name], tokens[tk_name]
            q, k, v, do = (torch.randn(batch, T, C, device=dev, generator=gen).bfloat16()
                           for T in (Tq, Tk, Tk, Tq))
            key = f"B={batch} {tq_name}<-{tk_name}"
            for masked, rate in itertools.product((False, True), (0.0, TRAIN_DROPOUT)):
                mask = keep_mask(Tq, Tk, "diag", device=dev, **MASK_DEFAULTS) if masked else None
                seed = 2000 + len(cases)
                tiles = None if mask is None else KA.mask_tiles(mask)
                o, lse = KA._forward_bf16(q, k, v, H, tiles, rate, seed, True)
                want_o = KA.flash_mha_plain(q, k, v, H, mask=mask, dropout=rate,
                                            dropout_seed=seed)
                lse_err = (lse - _lse_plain(q, k, H, mask)).abs().max().item()
                got = KA.flash_mha_bwd_bf16(q, k, v, o, do, H, lse=lse, mask=mask, dropout=rate,
                                            dropout_seed=seed)
                want = KA.flash_mha_bwd_plain(q, k, v, want_o, do, H, mask=mask, dropout=rate,
                                              dropout_seed=seed)
                errs = [_grad_err(g.float(), w.float()) for g, w in zip(got, want)]
                # the deterministic order's kernel, same inputs, on the keys the flag takes
                with deterministic():
                    got = KA.flash_mha_bwd_bf16(q, k, v, o, do, H, lse=lse, mask=mask,
                                                dropout=rate, dropout_seed=seed)
                det_errs = [_grad_err(g.float(), w.float()) for g, w in zip(got, want)]
                fwd = bf16_excess(o, want_o)
                worst["fwd_excess"] = max(worst["fwd_excess"], fwd)
                worst["lse"] = max(worst["lse"], lse_err)
                worst["bwd"] = max(worst["bwd"], *errs)
                worst["deterministic_bwd"] = max(worst["deterministic_bwd"], *det_errs)
                cases.append({"case": key, "mask": "diag" if masked else None, "dropout": rate,
                              "fwd_excess_over_tol": fwd, "lse_max_abs_err": lse_err,
                              "dq_dk_dv_err_over_peak": errs,
                              "deterministic_dq_dk_dv_err_over_peak": det_errs})
                del o, lse, want_o, got, want
            keep = dropout_keep(batch * H, Tq, Tk, TRAIN_DROPOUT, 77 + batch,
                                dev).view(batch, H, Tq, Tk)
            pattern = _drop_pattern_mismatches(q, k, H, TRAIN_DROPOUT, 77 + batch, keep)
            worst["pattern_mismatches"] += pattern
            # every plan at TRAIN_DROPOUT: its time, its output against the plain
            # version's, its drop pattern
            want_drop = KA.flash_mha_plain(q, k, v, H, dropout=TRAIN_DROPOUT,
                                           dropout_seed=77 + batch)
            plans_dropout = {}
            for bk, r, persistent in BF16_PLANS:
                with bf16_plan(KEY_TILE_BF16=bk, BF16_ROWS=r, BF16_PERSISTENT=persistent):
                    got = KA.flash_mha_bf16(q, k, v, H, dropout=TRAIN_DROPOUT,
                                            dropout_seed=77 + batch)
                    plan = {"excess_over_tol": bf16_excess(got, want_drop),
                            "drop_pattern_mismatches": _drop_pattern_mismatches(
                                q, k, H, TRAIN_DROPOUT, 77 + batch, keep),
                            "ms": cuda_ms(lambda: KA.flash_mha_bf16(
                                q, k, v, H, dropout=TRAIN_DROPOUT, dropout_seed=5))}
                plans_dropout[f"{bk} keys {r} rows {'persistent' if persistent else 'grid'}"] = plan
                worst["fwd_excess"] = max(worst["fwd_excess"], plan["excess_over_tol"])
                worst["pattern_mismatches"] += plan["drop_pattern_mismatches"]
            rows_chosen, ctas = KA.bf16_plan(batch, Tq, Tk, H, sm)
            chosen = (f"{KA.KEY_TILE_BF16} keys {rows_chosen} rows "
                      f"{'grid' if ctas == -(-Tq // rows_chosen) * H * batch else 'persistent'}")
            dropout_plan = dict(chosen=chosen, chosen_over_fastest=plans_dropout[chosen]["ms"]
                                / min(v["ms"] for v in plans_dropout.values()))
            del keep, want_drop, got
            o, lse = KA._forward_bf16(q, k, v, H, None, 0.0, 0, True)
            want = KA.flash_mha_bwd_plain(q, k, v, o, do, H)
            keys_sweep = {}
            for keys in (64, 128):
                KA.BWD_KEYS_BF16 = keys
                try:
                    got = KA.flash_mha_bwd_bf16(q, k, v, o, do, H, lse=lse)
                    worst["bwd"] = max(worst["bwd"], *(_grad_err(g.float(), w.float())
                                                       for g, w in zip(got, want)))
                    with deterministic():
                        got = KA.flash_mha_bwd_bf16(q, k, v, o, do, H, lse=lse)
                    worst["deterministic_bwd"] = max(
                        worst["deterministic_bwd"],
                        *(_grad_err(g.float(), w.float()) for g, w in zip(got, want)))
                    rerun[f"{key} keys={keys}"] = _rerun_gap(KA.flash_mha_bwd_bf16, q, k, v, o,
                                                             do, H, lse)
                    keys_sweep[f"{keys} keys"] = cuda_ms(
                        lambda: KA.flash_mha_bwd_bf16(q, k, v, o, do, H, lse=lse))
                    keys_sweep[f"{keys} keys deterministic"] = _deterministic_ms(
                        lambda: KA.flash_mha_bwd_bf16(q, k, v, o, do, H, lse=lse))
                finally:
                    KA.BWD_KEYS_BF16 = None
            del got, want
            flops = 5 * 2 * batch * H * Tq * Tk * d
            nbytes = 2 * batch * (4 * Tq + 4 * Tk) * C + 4 * batch * H * Tq
            b_ms, b_by = bound(flops, nbytes, BF16_FLOPS)
            split = [t.view(batch, -1, H, d).transpose(1, 2).detach().clone().requires_grad_()
                     for t in (q, k, v)]
            so = F.scaled_dot_product_attention(*split)
            so_drop = F.scaled_dot_product_attention(*split, dropout_p=TRAIN_DROPOUT)
            sdo = do.view(batch, Tq, H, d).transpose(1, 2)

            def sdpa(p=0.0):
                return _sdpa_no_grad(split, p)

            row = dict(
                ms=cuda_ms(lambda: KA.flash_mha_bwd_bf16(q, k, v, o, do, H, lse=lse)),
                ms_dropout=cuda_ms(lambda: KA.flash_mha_bwd_bf16(
                    q, k, v, o, do, H, lse=lse, dropout=TRAIN_DROPOUT, dropout_seed=5)),
                fwd_ms=cuda_ms(lambda: KA.flash_mha_bf16(q, k, v, H)),
                fwd_ms_dropout=cuda_ms(lambda: KA.flash_mha_bf16(
                    q, k, v, H, dropout=TRAIN_DROPOUT, dropout_seed=5)),
                sdpa_fwd_ms=cuda_ms(sdpa),
                sdpa_fwd_ms_dropout=cuda_ms(lambda: sdpa(TRAIN_DROPOUT)),
                sdpa_bwd_ms=cuda_ms(lambda: torch.autograd.grad(so, split, sdo,
                                                                retain_graph=True)),
                sdpa_bwd_ms_dropout=cuda_ms(lambda: torch.autograd.grad(
                    so_drop, split, sdo, retain_graph=True)),
                bound_ms=b_ms, bound_by=b_by,
                fwd_bound_ms=bound(flops * 2 / 5, 2 * 2 * batch * (Tq + Tk) * C, BF16_FLOPS)[0],
                drop_pattern_mismatches=pattern, plans_dropout=plans_dropout,
                dropout_plan=dropout_plan,
                keys_sweep_ms=keys_sweep,
                keys=KA.bwd_keys(batch, Tk, H, sm))
            # under the flag: the keys bwd_keys takes there and their time; at both block
            # sizes the launch's grid, order, rounds of heads and dQ ring, as it reports them
            with deterministic():
                row["deterministic_keys"] = KA.bwd_keys(batch, Tk, H, sm)
            row["deterministic_ms"] = keys_sweep[f"{row['deterministic_keys']} keys "
                                                 "deterministic"]
            row["deterministic_over_bwd"] = row["deterministic_ms"] / row["ms"] - 1
            row["deterministic_plans"] = {n: KA.bwd_plan(torch.bfloat16, n, batch, Tq, Tk, H, d)
                                          for n in (64, 128)}
            row["chosen_keys_over_fastest"] = (keys_sweep[f"{row['keys']} keys"]
                                               / min(keys_sweep[f"{n} keys"] for n in (64, 128)))
            row["fwd_dropout_over_fwd"] = row["fwd_ms_dropout"] / row["fwd_ms"] - 1
            row["dropout_over_bwd"] = row["ms_dropout"] / row["ms"] - 1
            if tq_name == tk_name == "freq":
                row["plain_ms"] = cuda_ms(lambda: KA.flash_mha_bwd_plain(q, k, v, o, do, H),
                                          repeat=3)
                row["fwd_plain_ms_dropout"] = cuda_ms(lambda: KA.flash_mha_plain(
                    q, k, v, H, dropout=TRAIN_DROPOUT, dropout_seed=5), repeat=3)
            by_shape[key] = row
            del q, k, v, do, o, lse, split, so, so_drop
            torch.cuda.empty_cache()
    main = by_shape[f"B={TRAIN_BATCH} freq<-freq"]
    instances = bwd_instances("Bf16Bwd")
    fwd_instances = {k: v for k, v in bf16_instances().items()  # D = 128's: head_dims phase
                     if k.endswith("dropout") and not k.startswith("d=128")}
    worst["rerun_dq_gap"] = max(r["dq_gap_over_peak"] for r in rerun.values())
    ok = (worst["fwd_excess"] <= 0 and worst["lse"] <= K3_BF16_LSE_ATOL
          and worst["bwd"] <= K3_BF16_BWD_RTOL and worst["pattern_mismatches"] == 0
          and worst["rerun_dq_gap"] <= K3_BF16_BWD_RERUN_RTOL
          and worst["deterministic_bwd"] <= K3_BF16_BWD_RTOL
          and all(r["dk_dv_equal"] and r["deterministic_equal"] for r in rerun.values())
          and all(p["twin_agrees"] for r in by_shape.values()
                  for p in r["deterministic_plans"].values())
          and _no_spills(instances) and len(fwd_instances) == 12 and _no_spills(fwd_instances))
    return dict(
        name="flash_mha_bwd_bf16", tol=K3_BF16_BWD_RTOL, max_abs_err=worst["bwd"],
        deterministic_max_abs_err=worst["deterministic_bwd"],
        max_err_is="over each gradient's peak", worst=worst, within_tol=ok,
        rerun=rerun, rerun_tol=K3_BF16_BWD_RERUN_RTOL, instances=instances,
        fwd_dropout_instances=fwd_instances,
        fwd_tol=K3_BF16_TOL, lse_tol=K3_BF16_LSE_ATOL,
        source="demucs_tpu_torch/csrc/flash_mha_bwd.cu",
        replaces="demucs_tpu/ops/pallas/attention.py:103 (the gradient of its function on bf16 "
                 "inputs; the Pallas kernel has no backward, JAX trains through XLA's dense "
                 "attention)",
        ms=main["ms"], plain_ms=main["plain_ms"], library_ms=main["sdpa_bwd_ms"],
        deterministic_ms=main["deterministic_ms"],
        library="autograd.grad of F.scaled_dot_product_attention (bf16)",
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        bound_rule="max(5 x 2 B H Tq Tk d / 989 TFLOP/s (five bf16 products), bytes of q, k, "
                   "v, o, dO, lse in and dQ, dK, dV out / 3.35 TB/s)",
        shape=f"q, k, v (B={TRAIN_BATCH}, 2688, 512) bf16, 8 heads (freq self)",
        by_shape=by_shape, cases=cases)


def train_stft_checks(gen) -> dict:
    """K2's backward (K1's kernel on the output gradient, scaled per bin) and
    K1's (K2's kernel on the scaled gradients) at the training step's
    HTDemucs shape (B = 1 and TRAIN_BATCH, 340 frames) and at one and two 44 s
    HDemucs segments: against their plain versions on the same inputs and
    against autograd through the plain K2 / K1 (KERNEL_RTOL x peak). Times
    K2's backward, its plain version and torch.stft on the same gradient."""
    import torch

    from demucs_tpu_torch.kernels import stft as KS

    dev = torch.device("cuda")
    n_fft, hop, freqs = 4096, 1024, 2049
    window = torch.hann_window(n_fft, device=dev)
    shapes, worst, k1_worst = {}, 0.0, 0.0
    for name, rows, frames in (("B=1", 8, 340), (f"B={TRAIN_BATCH}", 8 * TRAIN_BATCH, 340),
                               ("HDemucs 44 s B=1", 8, 1899), ("HDemucs 44 s B=2", 16, 1899)):
        length = (frames - 1) * hop + n_fft
        g = torch.randn(rows, length, device=dev, generator=gen)
        got = KS.istft_dft_backward(g, n_fft, hop)
        want = KS.istft_dft_backward_plain(g, n_fft, hop)
        zr = torch.zeros(rows, frames, freqs, device=dev, requires_grad=True)
        zi = torch.zeros(rows, frames, freqs, device=dev, requires_grad=True)
        auto = torch.autograd.grad(KS.istft_dft_plain(zr, zi, n_fft, hop), (zr, zi), g)
        err = max(_grad_err(a, b) for a, b in zip(got + got, want + auto))
        del zr, zi, auto
        gr, gi = want  # K1's backward at an input 77 samples past its last frame
        k1 = KS.stft_dft_backward(gr, gi, n_fft, hop, length + 77)
        x = torch.zeros(rows, length + 77, device=dev, requires_grad=True)
        pr, pi = KS.stft_dft_plain(x, n_fft, hop)
        (auto,) = torch.autograd.grad((pr * gr).sum() + (pi * gi).sum(), x)
        k1_err = max(_grad_err(k1, KS.stft_dft_backward_plain(gr, gi, n_fft, hop, length + 77)),
                     _grad_err(k1, auto))
        del x, pr, pi, auto
        worst, k1_worst = max(worst, err), max(k1_worst, k1_err)
        nframes = rows * frames
        flops = nframes * (n_fft + fft_flops(n_fft) + 2 * freqs)  # window, real FFT, scale
        b_ms, b_by = bound(flops, 4 * (g.numel() + 2 * nframes * freqs))
        shapes[name] = dict(
            max_err_over_peak=err, ms=cuda_ms(lambda: KS.istft_dft_backward(g, n_fft, hop)),
            plain_ms=cuda_ms(lambda: KS.istft_dft_backward_plain(g, n_fft, hop), repeat=3),
            library_ms=cuda_ms(lambda: torch.stft(g, n_fft, hop, window=window, center=False,
                                                  return_complex=True)),
            bound_ms=b_ms, bound_by=b_by, k1_backward_err_over_peak=k1_err,
            k1_backward_ms=cuda_ms(lambda: KS.stft_dft_backward(gr, gi, n_fft, hop, length)),
            shape=f"g {tuple(g.shape)} -> 2 x ({rows}, {frames}, {freqs})")
        del g, got, want, gr, gi, k1
        torch.cuda.empty_cache()
    KS._stft_basis.cache_clear()
    KS._istft_basis.cache_clear()
    main = shapes[f"B={TRAIN_BATCH}"]
    return dict(
        name="istft_dft_backward", tol=KERNEL_RTOL, max_abs_err=worst,
        max_err_is="over the gradient's peak", stft_dft_backward_err=k1_worst,
        within_tol=worst <= KERNEL_RTOL and k1_worst <= KERNEL_RTOL,
        source="demucs_tpu_torch/csrc/stft.cu (K1's kernel)",
        replaces="demucs_tpu/ops/pallas/stft.py:137 (the gradient of istft_chunk_dft)",
        ms=main["ms"], plain_ms=main["plain_ms"], library_ms=main["library_ms"],
        library="torch.stft(center=False) of the gradient, without the per-bin scale",
        bound_ms=main["bound_ms"], bound_by=main["bound_by"], shape=main["shape"],
        by_shape=shapes)


def _released_training_model(seed: int = 0, **kw):
    """The released HTDemucs for training: seeded weights, every parameter an
    fp32 master (a bf16 stage casts them on each forward); ``kw`` over the
    released options (``t_heads=4``: heads of 128 channels)."""
    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs
    from demucs_tpu_torch.models.registry import Model

    cfg = HTDemucsConfig(**dict(RELEASED, segment=TRAIN_SEGMENT, **kw))
    return Model("htdemucs", cfg, init_htdemucs(cfg, seed=seed, layer_scale=1.0,
                                                 random_norms=True, fp32_masters=True).train())


def _optimizer(model, lr: float):
    """``train/step.py::make_optimizer`` (Adam) at ``lr``."""
    from demucs_tpu_torch.train.config import TrainArgs
    from demucs_tpu_torch.train.step import make_optimizer

    args = TrainArgs()
    args.optim.lr = lr
    return make_optimizer(args, model)


def _grads(model) -> dict:
    return {n: p.grad.detach().cpu() for n, p in model.module.named_parameters()}


def train_card_vs_cpu(**model_kw) -> tp.Tuple[dict, dict]:
    """One train step of the released-width HTDemucs at batch 1 (its 7.8 s
    training segment, dropout 0, no augment, lr 0, TRAIN_CHECK_LOSS) on the
    card and on the CPU from the same weights and batch: loss, per-source
    reco and the gradient's global norm within TRAIN_RTOL x their peak, and
    every parameter's gradient within TRAIN_GRAD_RTOL x its own peak plus
    TRAIN_GRAD_FLOOR x the largest gradient's peak. The card's step runs
    once by default (cuDNN's weight gradients and K3's dQ sum with atomics,
    in another order each run) and twice under deterministic(), where the
    two must be bit-equal (C5); each is held to the CPU's. The gap between
    the default step and the deterministic one is reported beside. Returns
    the report and the step's model, batch and gradients, which the bf16
    step and the C2 probe reuse. ``model_kw``: the model's options (the
    sparse path's static masks)."""
    import torch

    from demucs_tpu_torch.models.registry import Model
    from demucs_tpu_torch.train.step import train_step

    cpu = _released_training_model(seed=3, **model_kw)
    card = Model("htdemucs", cpu.cfg, copy.deepcopy(cpu.module).to("cuda"))
    sources = 0.2 * torch.randn(1, 4, 2, cpu.cfg.training_length,
                                generator=torch.Generator().manual_seed(4))

    def card_step():
        got = train_step(card, _optimizer(card, 0.0), sources.to("cuda"), loss=TRAIN_CHECK_LOSS)
        return got, {n: p.grad.cpu() for n, p in card.module.named_parameters()}

    runs = {"default": card_step()}
    with deterministic():  # C5: the two card steps must agree bit for bit
        ordered = [card_step() for _ in range(2)]
    runs["deterministic"] = ordered[-1]
    torch.cuda.synchronize()
    start = time.perf_counter()
    want = train_step(cpu, _optimizer(cpu, 0.0), sources, loss=TRAIN_CHECK_LOSS)
    cpu_s = time.perf_counter() - start
    grads = {n: p.grad for n, p in cpu.module.named_parameters()}
    peak = max(g.abs().max().item() for g in grads.values())

    def worst(a, b):
        rel = {n: ((a[n] - b[n]).abs().max() / b[n].abs().max().clamp_min(1e-30)).item()
               for n in b}
        name = max(rel, key=rel.get)
        return {"name": name, "err_over_its_peak": rel[name],
                "its_peak_over_largest": grads[name].abs().max().item() / peak}

    info = {"batch": 1, "segment_s": TRAIN_SEGMENT, "loss_kind": TRAIN_CHECK_LOSS,
            "loss": want["loss"].item(), "n_grads": len(grads),
            "largest_grad": max(grads, key=lambda n: grads[n].abs().max().item()),
            "worst_grad_default_vs_deterministic": worst(runs["default"][1],
                                                         runs["deterministic"][1]),
            "card_twice_bit_equal": all(bool(torch.equal(ordered[0][1][n], ordered[1][1][n]))
                                        for n in grads),
            "tol": TRAIN_RTOL, "grad_tol": f"{TRAIN_GRAD_RTOL} x its peak + {TRAIN_GRAD_FLOOR} "
                                          "x the largest peak", "cpu_step_s": cpu_s,
            "cpu_threads": torch.get_num_threads()}
    ok = info["card_twice_bit_equal"]
    for name, (got, card_grads) in runs.items():
        errs = {k: ((got[k].cpu() - want[k]).abs().max() / want[k].abs().max()).item()
                for k in ("loss", "reco", "grad_norm")}
        # each gradient's error over its allowance (<= 1 passes)
        over = {n: (card_grads[n] - g).abs().max().item()
                / (TRAIN_GRAD_RTOL * g.abs().max().item() + TRAIN_GRAD_FLOOR * peak)
                for n, g in grads.items()}
        info[name] = {"errs_over_peak": errs, "grad_err_over_allowance": max(over.values()),
                      "largest_errs_over_allowance": dict(sorted(over.items(),
                                                                 key=lambda kv: -kv[1])[:6]),
                      "worst_grad_vs_cpu": worst(card_grads, grads)}
        ok = (ok and max(errs.values()) <= TRAIN_RTOL and max(over.values()) <= 1
              and all(torch.isfinite(g).all() for g in card_grads.values()))
    info["ok"] = ok
    del card
    torch.cuda.empty_cache()
    return info, {"cpu": cpu, "sources": sources, "grads": grads,
                  "card_grads": runs["default"][1], "metrics": want}


def train_bf16_card_vs_cpu(step: dict) -> tp.Tuple[dict, dict]:
    """One bf16 mixed-precision step (compute_dtype="bfloat16": fp32 masters,
    each stage cast to bf16 on the forward) of train_card_vs_cpu's model and
    batch (its TRAIN_CHECK_LOSS) on the card and on the CPU. The CPU anchor's bound
    (tests/test_torch_train.py, against JAX), with the CPU's bf16 step in
    JAX's place: loss and reco within TRAIN_BF16_RTOL, the global norm within
    TRAIN_BF16_NORM_RTOL (relative), each gradient within twice the CPU's own
    gap between its bf16 and fp32 steps plus TRAIN_BF16_GRAD_FLOOR x the
    largest gradient's peak. The card's gradients and Adam state are fp32.
    The card's step runs once by default and twice under deterministic()
    (K3's bf16 backward in its deterministic order): those two must be
    bit-equal, and each way is held to the CPU's. Returns the report and the
    launches of the two deterministic card steps (every count from 0)."""
    import torch

    from demucs_tpu_torch.models.registry import Model
    from demucs_tpu_torch.train.step import train_step

    cfg = dataclasses.replace(step["cpu"].cfg, compute_dtype="bfloat16")
    models = []
    for device in ("cuda", "cpu"):
        module = copy.deepcopy(step["cpu"].module).to(device)
        module.cfg = cfg
        models.append(Model("htdemucs", cfg, module))
    card, cpu = models

    def card_step():
        opt = _optimizer(card, 0.0)
        got = train_step(card, opt, step["sources"].to("cuda"), loss=TRAIN_CHECK_LOSS)
        return got, {n: p.grad.detach().cpu() for n, p in card.module.named_parameters()}, opt

    runs = {"default": card_step()}
    _zero_train_counts()
    with deterministic():  # the two card steps must agree bit for bit
        ordered = [card_step() for _ in range(2)]
    torch.cuda.synchronize()
    counts = _read_train_counts()
    runs["deterministic"] = ordered[-1]
    start = time.perf_counter()
    want = train_step(cpu, _optimizer(cpu, 0.0), step["sources"], loss=TRAIN_CHECK_LOSS)
    cpu_s = time.perf_counter() - start
    g_cpu, g_cpu32 = _grads(cpu), step["grads"]
    peak = max(g.abs().max().item() for g in g_cpu.values())
    info = {"batch": 1, "segment_s": TRAIN_SEGMENT, "compute_dtype": "bfloat16",
            "loss_kind": TRAIN_CHECK_LOSS,
            "loss": want["loss"].item(), "loss_fp32": step["metrics"]["loss"].item(),
            "cpu_step_s": cpu_s,
            "card_twice_bit_equal": all(bool(torch.equal(ordered[0][1][n], ordered[1][1][n]))
                                        for n in g_cpu),
            "deterministic_launches": counts,
            "tol": {"loss_reco": TRAIN_BF16_RTOL, "grad_norm": TRAIN_BF16_NORM_RTOL,
                    "grad": f"2 x |cpu bf16 - cpu fp32| + {TRAIN_BF16_GRAD_FLOOR} x peak"}}
    ok = (info["card_twice_bit_equal"] and counts["flash_mha_bwd_bf16"] > 0
          and counts["flash_mha_bwd"] == 0)
    for name, (got, g_card, opt) in runs.items():
        errs = {k: ((got[k].cpu() - want[k]).abs().max() / want[k].abs().max()).item()
                for k in ("loss", "reco", "grad_norm")}
        excess = {}
        for n, g in g_cpu.items():
            gap = (g_card[n] - g).abs().max().item()
            allowed = 2 * (g - g_cpu32[n]).abs().max().item() + TRAIN_BF16_GRAD_FLOOR * peak
            excess[n] = {"gap_over_largest_peak": gap / peak, "allowed_over_largest_peak":
                         allowed / peak, "ok": gap <= allowed}
        fp32 = (all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                    for p in card.module.parameters())
                and all(t.dtype == torch.float32 for st in opt.state.values()
                        for t in st.values() if t.dim() > 0))
        worst = sorted(excess, key=lambda n: -excess[n]["gap_over_largest_peak"])[:6]
        info[name] = {"errs_rel": errs, "largest_gaps": {n: excess[n] for n in worst},
                      "grads_over_bound": [n for n, e in excess.items() if not e["ok"]],
                      "masters_grads_adam_fp32": fp32}
        ok = (ok and errs["loss"] <= TRAIN_BF16_RTOL and errs["reco"] <= TRAIN_BF16_RTOL
              and errs["grad_norm"] <= TRAIN_BF16_NORM_RTOL
              and not info[name]["grads_over_bound"] and fp32)
    info["ok"] = ok
    del card, cpu, runs, ordered
    torch.cuda.empty_cache()
    return info, counts


def train_c2_probe(step: dict) -> dict:
    """C2 (ROADMAP.md Queue C): train_card_vs_cpu's step, on the l1 loss (the
    training default: its gradient is the sign of each residual) and on mse,
    on the card (l1 also with cuDNN deterministic and with remat) and on the
    CPU in fp32, each against the same step in float64 on the CPU (the
    truth), tensor by tensor, over each tensor's true peak (tensors whose true
    peak is at least C2_PEAK_SHARE of the largest; the others, biases before a
    norm, have zero true gradients); with the residuals whose sign each run
    flips against the truth. A run is "far off" on a tensor where its error
    exceeds C2_RATIO times the CPU's and C2_FLOOR."""
    import torch

    from demucs_tpu_torch.models.registry import Model
    from demucs_tpu_torch.train.step import train_step

    def run(device, dtype, loss, deterministic=False, remat=False):
        module = copy.deepcopy(step["cpu"].module).to(device, dtype)
        module.remat = remat
        model = Model("htdemucs", step["cpu"].cfg, module)
        out = {}
        hook = module.register_forward_hook(lambda m, a, y: out.__setitem__("y", y.detach()))
        with torch.backends.cudnn.flags(enabled=True, benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=deterministic, allow_tf32=False):
            start = time.perf_counter()
            train_step(model, _optimizer(model, 0.0), step["sources"].to(device, dtype),
                       loss=loss)
            seconds = time.perf_counter() - start
        hook.remove()
        residual = (out["y"].double().cpu() - step["sources"].double())
        grads = _grads(model)
        del model, module
        torch.cuda.empty_cache()
        return grads, residual, seconds

    report = {"truth": "float64 on the CPU"}
    for loss in ("l1", "mse"):
        g64, r64, truth_s = run("cpu", torch.float64, loss)
        runs = {"cpu": run("cpu", torch.float32, loss), "card": run("cuda", torch.float32, loss)}
        if loss == "l1":
            runs["card_deterministic"] = run("cuda", torch.float32, loss, deterministic=True)
            runs["card_remat"] = run("cuda", torch.float32, loss, remat=True)
        largest = max(g.abs().max().item() for g in g64.values())
        peaks = {n: g.abs().max().item() for n, g in g64.items()}
        kept = [n for n in g64 if peaks[n] >= C2_PEAK_SHARE * largest]
        err = {name: {n: (g[n].double() - g64[n]).abs().max().item() / peaks[n] for n in kept}
               for name, (g, _, _) in runs.items()}
        far = {name: sum(1 for n in kept if e[n] > C2_RATIO * err["cpu"][n] and e[n] > C2_FLOOR)
               for name, e in err.items() if name != "cpu"}
        top = sorted(kept, key=lambda n: -err["card"][n])[:4]
        watch = [n for n in ("encoder.2.conv.weight",) if n in kept and n not in top]
        report[loss] = {
            "truth_step_s": truth_s, "tensors": len(kept),
            "median_err_over_true_peak": {k: sorted(e.values())[len(e) // 2]
                                          for k, e in err.items()},
            "max_err_over_true_peak": {k: max(e.values()) for k, e in err.items()},
            "largest_card_errs": {n: {k: err[k][n] for k in err} for n in top + watch},
            "tensors_far_off": far,
            "residual_signs_flipped": {k: int(((r.sign() != r64.sign()) & (r64 != 0)).sum())
                                       for k, (_, r, _) in runs.items()},
            "smallest_true_residual": r64.abs().min().item(),
            "output_err_over_peak": {k: ((r - r64).abs().max() / (r64 + step["sources"].double())
                                         .abs().max()).item() for k, (_, r, _) in runs.items()}}
    card_far = report["mse"]["tensors_far_off"]["card"] > 0
    report["verdict"] = ("card" if card_far else "l1 sign flips"
                         if report["l1"]["tensors_far_off"]["card"] else "summation order")
    report["rule"] = (f"far off: > {C2_RATIO} x the CPU's error and > {C2_FLOOR}, over the true "
                      f"peak of each tensor whose true peak is >= {C2_PEAK_SHARE} x the largest")
    report["ok"] = all(math.isfinite(v) for loss in ("l1", "mse")
                       for e in report[loss]["max_err_over_true_peak"].values() for v in [e])
    return report


def _profile_step(step) -> dict:
    """One call of ``step`` under torch.profiler: device time by kernel group,
    the top kernels and the device's idle share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    groups: dict = {}
    top = []
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if evt.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        key = _kernel_group(evt.key)
        groups[key] = groups.get(key, 0.0) + us / 1e3
        top.append((us / 1e3, evt.count, evt.key[:90]))
    device_ms = sum(groups.values())
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "idle_share": 1 - device_ms / (wall * 1e3) if device_ms else "not measured",
            "by_group_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"ms": ms, "calls": n, "name": key}
                            for ms, n, key in sorted(top, reverse=True)[:12]]}


def train_throughput(compute_dtype: str = "float32", steps: int = TRAIN_STEPS,
                     detail: bool = True, **model_kw) -> tp.Tuple[dict, dict]:
    """The main training path: ``train_step`` at the released width, batch
    TRAIN_BATCH (4 if 8 does not fit), 7.8 s, fp32 with TF32 off (or bf16
    mixed precision: fp32 masters, every core stage in bf16), TRAIN_STEPS
    steps with every launch counted from 0; training audio-s/s over steps
    3-12; then the forward / backward / optimizer split (CUDA events, 3
    steps), the peak memory and one profiled step (not without ``detail``).
    The bf16 path must launch K3's bf16 kernels and no fp32 K3 kernel.
    ``steps``: the steps run (from the third timed); ``model_kw``: the
    model's options (the sparse path's static masks: every K3 backward then
    masked; a ``t_dropout``, drawn from one seeded generator)."""
    import statistics

    import torch

    from demucs_tpu_torch.train.step import (backward_precision, clip_and_step, forward_loss,
                                             train_step)

    for batch in (TRAIN_BATCH, 4):
        model = _released_training_model(seed=5, compute_dtype=compute_dtype, **model_kw)
        model.module.to("cuda")
        opt = _optimizer(model, 3e-4)
        sources = 0.2 * torch.randn(batch, 4, 2, model.cfg.training_length, device="cuda",
                                    generator=torch.Generator(device="cuda").manual_seed(6))
        gen = torch.Generator().manual_seed(9)  # the transformer's dropout draws, if any
        held = torch.cuda.memory_allocated() / 2**30  # with the weights, before any step
        torch.cuda.reset_peak_memory_stats()
        try:
            _zero_train_counts()
            walls, losses = [], []
            for _ in range(steps):
                start = time.perf_counter()
                m = train_step(model, opt, sources, generator=gen)
                losses.append(m["loss"].item())  # synchronizes
                walls.append(time.perf_counter() - start)
            counts = _read_train_counts()
            break
        except torch.cuda.OutOfMemoryError:
            del model, opt, sources
            torch.cuda.empty_cache()
            if batch == 4:
                raise
    peak = torch.cuda.max_memory_allocated() / 2**30
    split = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(3 if detail else 0):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        value, _ = forward_loss(model, sources, "l1", (1.0,) * 4, generator=gen)
        ev[1].record()
        with backward_precision(model):
            value.backward()
        ev[2].record()
        clip_and_step(opt, 0.0)
        ev[3].record()
        torch.cuda.synchronize()
        for (name, a, b) in (("forward", 0, 1), ("backward", 1, 2), ("optimizer", 2, 3)):
            split[name].append(ev[a].elapsed_time(ev[b]))
    profile = (_profile_step(lambda: train_step(model, opt, sources, generator=gen)) if detail
               else None)
    timed = walls[2:]
    median = statistics.median(timed)
    info = {"compute_dtype": compute_dtype, "batch": batch, "batch_8_fit": batch == TRAIN_BATCH,
            "segment_s": TRAIN_SEGMENT,
            "steps": steps, "step_walls_s": walls, "median_step_s": median,
            "train_audio_s_per_s": batch * TRAIN_SEGMENT / median,
            "losses": losses, "peak_memory_gib": peak, "held_before_gib": held,
            "peak_above_held_gib": peak - held,
            "split_ms_median": {k: statistics.median(v) for k, v in split.items() if v},
            "split_ms": split, "launches": counts,
            "launches_per_step": {k: v / steps for k, v in counts.items()},
            "profile": profile}
    if compute_dtype == "bfloat16":
        launched = (all(counts[name] > 0 for name in TRAIN_BF16_KERNELS)
                    and counts["flash_mha"] == counts["flash_mha_bwd"] == 0)
        info["masters_grads_adam_fp32"] = (
            all(p.dtype == p.grad.dtype == torch.float32 for p in model.module.parameters())
            and all(t.dtype == torch.float32 for st in opt.state.values() for t in st.values()
                    if t.dim() > 0))
        launched = launched and info["masters_grads_adam_fp32"]
    else:
        launched = all(counts[name] > 0 for name in TRAIN_KERNELS if name != "stft_dft_backward")
    info["ok"] = all(math.isfinite(x) for x in losses) and launched
    del model, opt, sources
    torch.cuda.empty_cache()
    return info, counts


def _train_folder(root: Path, train_s: float = 20.0, valid_s: float = 10.0) -> Path:
    """A wav dataset (train/ and valid/ folders of tracks, one WAV per stem,
    16-bit at 44.1 kHz, the mixture left for the dataset to write): two
    ``train_s`` training tracks and one ``valid_s`` valid track of tones and
    noise from a seed."""
    import numpy as np

    from demucs_tpu_torch.audio import write_wav

    for split, tracks, seconds in (("train", 2, train_s), ("valid", 1, valid_s)):
        t = np.arange(int(seconds * SR)) / SR
        for i in range(tracks):
            folder = root / split / f"track{i}"
            folder.mkdir(parents=True)
            rng = np.random.default_rng(300 + 10 * i + len(split))
            for j, name in enumerate(("drums", "bass", "other", "vocals")):
                tone = 0.15 * np.sin(2 * np.pi * 55.0 * (j + 1) * (i + 2) * t + j)
                wav = np.stack([tone, 0.7 * tone]) + 0.02 * rng.standard_normal((2, t.size))
                write_wav(folder / f"{name}.wav", wav.astype(np.float32), SR)
    return root


def _entry_command(counted: Path) -> list:
    """``python -m demucs_tpu_torch.train`` as run through chip_smoke's
    ``--entry-counts``: the same entry point in a process of its own, which
    writes the kernels' launches (eager and graph replays) to ``counted``
    when the run ends (not when it is killed)."""
    return [sys.executable, str(ROOT / "chip_smoke.py"), "--entry-counts", str(counted),
            "demucs_tpu_torch.train"]


def entry_counts(counted: Path, module: str, argv: list) -> int:
    """``python -m module argv`` in this process (runpy), then the launches of
    the training kernels it made, as JSON to ``counted``: each kernel's count,
    and under "<name> dropout" those of K3's forward and backward launches
    that ran the hashed dropout (rate > 0)."""
    import collections
    import runpy

    from demucs_tpu_torch.inference.engine import GRAPHS
    from demucs_tpu_torch.kernels import attention as KA

    dropping = collections.Counter()

    def counting(fn, rate_at, name=None):
        def launch(*args, **kw):
            if args[rate_at] > 0:
                dropping[(name or args[0].replace("_f32", "")) + " dropout"] += 1
            return fn(*args, **kw)
        return launch

    KA._forward_f32 = counting(KA._forward_f32, 5, "flash_mha")
    KA._forward_bf16 = counting(KA._forward_bf16, 5, "flash_mha_bf16")
    KA._launch_bwd = counting(KA._launch_bwd, 10)
    sys.argv = [module, *argv]
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    finally:
        counts = {name: n + GRAPHS.replayed_launches.get(name, 0)
                  for name, n in _read_train_counts().items()}
        counted.write_text(json.dumps(dict(counts, **dropping)))
    return 0


def _entry_launches(counted: Path) -> dict:
    return json.loads(counted.read_text()) if counted.exists() else {}


def train_entry_point(workdir: Path) -> dict:
    """``python -m demucs_tpu_torch.train`` on a synthetic wav folder at the
    released width (t_dropout TRAIN_DROPOUT, batch ENTRY_BATCH, 8.8 s windows
    shifted by up to 1 s: 7.8 s inputs, every augment but repitch), 2 batches
    an epoch, 2 epochs: the process is killed once epoch 1's checkpoint is
    written (a preempted job), and the same command resumes it for epoch 2.
    The loss is finite, the history continues, and the best model separates
    a 10 s track through Separator on the card."""
    import json
    import os

    import numpy as np

    from demucs_tpu_torch.api import Separator

    data = _train_folder(workdir / "trainset")
    out = workdir / "train_out"
    model_args = ("{" + ", ".join(f"{k}: {v}" for k, v in RELEASED.items() if k != "samplerate")
                  + f", t_dropout: {TRAIN_DROPOUT}" + "}")
    counted = workdir / "train_entry_launches.json"
    cmd = [*_entry_command(counted), f"dset.wav={data}",
           "dset.use_musdb=false", "dset.segment=8.8", "dset.shift=1", f"dset.samplerate={SR}",
           f"dset.metadata={workdir / 'train_meta'}", f"model_segment={TRAIN_SEGMENT}",
           f"model_args={model_args}", f"batch_size={ENTRY_BATCH}", "epochs=2", "max_batches=1",
           "augment.repitch.proba=0", f"out_dir={out}", "misc.num_workers=4", "ema.epoch=[0.9]"]
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    start = time.perf_counter()
    first = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE, text=True)
    log1 = []
    for line in first.stderr:
        log1.append(line.rstrip())
        if "Checkpoint written: epoch 1" in line:
            first.kill()
            break
    first.wait(timeout=60)
    first.stderr.close()
    killed_s = time.perf_counter() - start
    if not any("Checkpoint written: epoch 1" in line for line in log1):
        raise AssertionError("the training entry point ended before epoch 1's checkpoint:\n"
                             + "\n".join(log1[-40:]))
    (folder,) = (out / "xps").iterdir()
    history1 = json.loads((folder / "history.json").read_text())
    start = time.perf_counter()
    second = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    resumed_s = time.perf_counter() - start
    log2 = second.stderr.splitlines()
    history = json.loads((folder / "history.json").read_text())
    sep = Separator("best", repo=folder, shifts=0)
    mix = _track(10.0, 5)
    _, stems = sep.separate_tensor(mix, SR)
    loading = [line.split("| ")[-1] if "| " in line else line.split(":", 2)[-1]
               for line in log1 + log2 if "waiting for data" in line]
    info = {"command": " ".join(cmd[1:]), "first_run_s": killed_s,
            "epochs_before_kill": len(history1), "resume_rc": second.returncode,
            "resume_run_s": resumed_s, "epochs_after_resume": len(history),
            "train_loss_by_epoch": [h["train"]["loss"] for h in history],
            "valid_loss_by_epoch": [h["valid"]["loss"] for h in history],
            "data_loading": loading, "best_model": str(folder / "best.dmx"),
            "separated_10s_stems": sorted(stems),
            "replayed_epoch_1": any("Replay | Epoch 1" in x for x in log2),
            "resumed_run_launches": _entry_launches(counted)}
    info["ok"] = (second.returncode == 0 and len(history1) == 1 and len(history) == 2
                  and info["resumed_run_launches"].get("flash_mha", 0) > 0
                  and history[:1] == history1 and info["replayed_epoch_1"]
                  and all(math.isfinite(x) for x in info["train_loss_by_epoch"])
                  and sorted(stems) == ["bass", "drums", "other", "vocals"]
                  and all(np.isfinite(s).all() and s.shape == mix.shape for s in stems.values()))
    if not info["ok"]:
        info["log_tail"] = (log1 + log2)[-40:]
    return info


def train_entry_point_bf16(workdir: Path) -> dict:
    """``python -m demucs_tpu_torch.train`` as a user trains in bf16 mixed
    precision, ``model_args={..., compute_dtype: bfloat16, t_dropout: 0.1}``
    (K3's bf16 dropout and backward run), one epoch of 2 batches on the
    synthetic wav folder (train_entry_point's epoch): the loss is finite, the checkpoint holds fp32
    weights, and the best model, read back with its bf16 compute_dtype,
    separates a 10 s track through Separator on the card."""
    import json
    import os
    import pickle

    import numpy as np

    from demucs_tpu_torch.api import Separator

    data = workdir / "trainset"
    if not data.exists():
        _train_folder(data)
    out = workdir / "train_out_bf16"
    model_args = ("{" + ", ".join(f"{k}: {v}" for k, v in RELEASED.items() if k != "samplerate")
                  + f", t_dropout: {TRAIN_DROPOUT}, compute_dtype: bfloat16" + "}")
    counted = workdir / "train_entry_bf16_launches.json"
    cmd = [*_entry_command(counted), f"dset.wav={data}",
           "dset.use_musdb=false", "dset.segment=8.8", "dset.shift=1", f"dset.samplerate={SR}",
           f"dset.metadata={workdir / 'train_meta'}", f"model_segment={TRAIN_SEGMENT}",
           f"model_args={model_args}", f"batch_size={ENTRY_BATCH}", "epochs=1", "max_batches=1",
           "augment.repitch.proba=0", f"out_dir={out}", "misc.num_workers=4"]
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    start = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - start
    (folder,) = (out / "xps").iterdir()
    history = json.loads((folder / "history.json").read_text())
    with open(folder / "checkpoint.pkl", "rb") as f:
        state = pickle.load(f)["state"]
    sep = Separator("best", repo=folder, shifts=0)
    module = sep.model.module
    mix = _track(10.0, 6)
    _, stems = sep.separate_tensor(mix, SR)
    info = {"command": " ".join(cmd[1:]), "rc": run.returncode, "wall_s": wall,
            "train_loss": [h["train"]["loss"] for h in history],
            "valid_loss": [h["valid"]["loss"] for h in history],
            "checkpoint_dtypes": sorted({str(v.dtype) for v in state.values()}),
            "served_compute_dtype": module.cfg.compute_dtype,
            "served_param_dtypes": sorted({str(p.dtype) for p in module.parameters()}),
            "separated_10s_stems": sorted(stems), "launches": _entry_launches(counted)}
    info["ok"] = (run.returncode == 0 and len(history) == 1
                  and info["launches"].get("flash_mha_bf16", 0) > 0
                  and all(math.isfinite(x) for x in info["train_loss"])
                  and all(v.dtype != np.float16 for v in state.values())
                  and "float32" in info["checkpoint_dtypes"]
                  and info["served_compute_dtype"] == "bfloat16"
                  and "torch.bfloat16" in info["served_param_dtypes"]
                  and sorted(stems) == ["bass", "drums", "other", "vocals"]
                  and all(np.isfinite(s).all() and s.shape == mix.shape for s in stems.values()))
    if not info["ok"]:
        info["log_tail"] = run.stderr.splitlines()[-40:]
    return info


def phase_train(workdir: Path) -> tp.Tuple[list, dict]:
    """K3's backward and dropout and K2's backward against their plain
    versions, on fp32 and (K3) on bf16 inputs; the card's train step against
    the CPU's, in fp32 and in bf16 mixed precision, and C2's float64 probe;
    the training rate at the released width in fp32 and in bf16; the
    training entry point with a resume, and once in bf16; the sparse path
    (SPARSE: K3's masked backward) card vs CPU in both precisions and its
    rate beside the dense one. Returns the backward kernels' rows and the
    launches of each path: the fp32 and the bf16 train paths, the bf16 card
    step run twice under deterministic(), the sparse paths' steps at batch
    8, and the entry points in their own processes (the fp32 one's resumed
    epoch, the bf16 one's epoch), both at t_dropout TRAIN_DROPOUT."""
    import torch

    from demucs_tpu_torch.inference.engine import GRAPHS

    GRAPHS.clear()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(10)
    start = time.perf_counter()
    info = {"phase": "train", "card": card_line()}
    with _fp32():
        rows = [train_k3_checks(gen), train_stft_checks(gen), train_k3_bf16_checks(gen)]
        info["kernels_s"] = time.perf_counter() - start
        info["card_vs_cpu_step"], step = train_card_vs_cpu()
        info["bf16_card_vs_cpu_step"], counts_bf16_det = train_bf16_card_vs_cpu(step)
        info["c2_probe"] = train_c2_probe(step)
        del step
        # the sparse path: HTDemucs's static masks in every self and cross layer (diag at
        # the reference's defaults), its K3 backward the masked instances
        info["sparse_card_vs_cpu_step"], step = train_card_vs_cpu(**SPARSE)
        info["sparse_bf16_card_vs_cpu_step"], counts_sparse_det = train_bf16_card_vs_cpu(step)
        del step
        info["steps_s"] = time.perf_counter() - start
        info["throughput"], counts = train_throughput()
        info["throughput_bf16"], counts_bf16 = train_throughput("bfloat16")
        info["throughput_sparse"], counts_sparse = train_throughput(
            steps=SPARSE_TRAIN_STEPS, detail=False, **SPARSE)
        info["throughput_sparse_bf16"], counts_sparse_bf16 = train_throughput(
            "bfloat16", steps=SPARSE_TRAIN_STEPS, detail=False, **SPARSE)
        for name, dense in (("throughput_sparse", "throughput"),
                            ("throughput_sparse_bf16", "throughput_bf16")):
            sparse = info[name]
            sparse["dense_median_step_s"] = info[dense]["median_step_s"]
            sparse["over_dense"] = sparse["median_step_s"] / info[dense]["median_step_s"]
            # every K3 backward of the sparse path is a masked one
            route = "flash_mha_bwd" if dense == "throughput" else "flash_mha_bwd_bf16"
            launched = sparse["launches"]
            sparse["ok"] = (sparse["ok"] and launched[route] > 0
                            and launched[f"{route} masked"] == launched[route])
        info["sparse_bf16_card_vs_cpu_step"]["ok"] = (
            info["sparse_bf16_card_vs_cpu_step"]["ok"]
            and counts_sparse_det["flash_mha_bwd_bf16 masked"]
            == counts_sparse_det["flash_mha_bwd_bf16"] > 0)
    info["entry_point"] = train_entry_point(workdir)
    info["entry_point_bf16"] = train_entry_point_bf16(workdir)
    info["wall_s"] = time.perf_counter() - start
    for row in rows:
        row["ok"] = row["within_tol"]
    info["kernel_rows"] = {r["name"]: {k: r[k] for k in ("max_abs_err", "tol", "ms", "plain_ms",
                                                          "library_ms", "bound_ms", "ok")}
                           for r in rows}
    emit(dict(info, k3_backward=rows[0], stft_backward=rows[1], k3_bf16_backward=rows[2]))
    bad = [r["name"] for r in rows if not r["ok"]]
    bad += [k for k in ("card_vs_cpu_step", "bf16_card_vs_cpu_step", "c2_probe", "throughput",
                        "throughput_bf16", "sparse_card_vs_cpu_step",
                        "sparse_bf16_card_vs_cpu_step", "throughput_sparse",
                        "throughput_sparse_bf16", "entry_point", "entry_point_bf16")
            if not info[k]["ok"]]
    if bad:
        raise AssertionError(f"train: {bad}")
    return rows, {"train": counts, "train bf16": counts_bf16,
                  "train bf16 deterministic": counts_bf16_det,
                  "train sparse": counts_sparse, "train sparse bf16": counts_sparse_bf16,
                  "train entry (resumed epoch)": info["entry_point"]["resumed_run_launches"],
                  "train bf16 entry": info["entry_point_bf16"]["launches"]}


RECIPE_SEGMENT = 11.0  # the reference's dset.segment (conf/config.yaml): 9.68 s after repitch
RECIPE_STEPS = 3  # each option's steps in train_recipe (the last two timed)
# the exact SVD penalty (sum of sigma_max^2), card vs CPU, relative: fp32 SVDs of matrices
# of up to 3456 columns by cuSOLVER and LAPACK (sigma_max to about n x fp32 epsilon each)
SVD_RTOL = 1e-4
QUANT_SER_MIN_DB = 10.0  # a quantized export's stems against the float model's, at least


def _recipe_argv(data: Path, workdir: Path, out: Path) -> list:
    """``python -m demucs_tpu_torch.train``'s arguments for the reference's
    default recipe (every augment at its default, repitch 0.2) at the
    released width, 11 s windows shifted by up to 1 s."""
    model_args = ("{" + ", ".join(f"{k}: {v}" for k, v in RELEASED.items() if k != "samplerate")
                  + "}")
    return [f"dset.wav={data}", "dset.use_musdb=false", f"dset.segment={RECIPE_SEGMENT}",
            "dset.shift=1", f"dset.samplerate={SR}", f"dset.metadata={workdir / 'recipe_meta'}",
            f"model_segment={TRAIN_SEGMENT}", f"model_args={model_args}",
            f"batch_size={ENTRY_BATCH}", "epochs=2", "max_batches=1", f"out_dir={out}",
            "misc.num_workers=4"]


def recipe_entry_point(workdir: Path) -> tp.Tuple[dict, dict]:
    """The slice's main path: ``demucs_tpu_torch.train.train.main`` (what
    ``python -m demucs_tpu_torch.train`` runs) in this process with the
    reference's defaults, 2 batches x 2 epochs, every launch counted from 0;
    then the same Solver one more epoch with every item repitched and one
    with none, for the data waits at repitch 0, 0.2 and 1 (and the items
    each epoch repitched); the device's idle share of the epoch's batch loop
    (torch.profiler) at repitch 0.2 and 1; and the ms of repitching one 11 s
    four-stem item at each pitch."""
    import statistics

    import numpy as np
    import torch

    from demucs_tpu_torch.inference.engine import GRAPHS
    from demucs_tpu_torch.train.repitch import RepitchedWrapper, repitch
    from demucs_tpu_torch.train.train import main

    data = workdir / "trainset"
    if not data.exists():
        _train_folder(data)
    argv = _recipe_argv(data, workdir, workdir / "recipe_out")
    fired: list = []  # (epoch, index) of each item the augment repitched
    plan = RepitchedWrapper.plan

    def counted(self, index, streams):
        out = plan(self, index, streams)
        if out is not None:
            fired.append((self.epoch, index))
        return out

    RepitchedWrapper.plan = counted
    try:
        start = time.perf_counter()
        _zero_train_counts()
        GRAPHS.reset_counts()
        solver = main(argv + ["device=cuda"])
        torch.cuda.synchronize()
        # the steps' launches and the validations' (graph replays among them)
        counts = {k: n + GRAPHS.replayed_launches.get(k, 0)
                  for k, n in _read_train_counts().items()}
        entry_s = time.perf_counter() - start
        wrapper = solver.loaders["train"].dataset
        probas = [wrapper.proba] * len(solver.timing)
        for proba in (1.0, 0.0):
            wrapper.proba = proba
            solver.args.epochs += 1
            solver.train()
            probas.append(proba)
        idle = {}
        for proba in (0.2, 1.0):  # the batch loop alone, no validation
            wrapper.proba = proba
            idle[proba] = _profile_step(lambda: solver._run_one_epoch(len(solver.timing)))
    finally:
        RepitchedWrapper.plan = plan
    waits = [dict(t, repitch_proba=p, repitched_items=sum(e == t["epoch"] for e, _ in fired))
             for t, p in zip(solver.timing, probas)]
    item = wrapper.dataset[0]  # an 11 s four-stem window
    per_pitch = {}
    for pitch in range(-wrapper.max_pitch, wrapper.max_pitch + 1):
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = np.stack([repitch(stem, pitch, 4.0, voice=k in wrapper.vocals,
                                    samplerate=SR, backend=wrapper.backend)
                            for k, stem in enumerate(item)])
            times.append((time.perf_counter() - t0) * 1e3)
        per_pitch[pitch] = min(times)
    launched = all(counts[name] > 0 for name in TRAIN_KERNELS if name != "stft_dft_backward")
    losses = [h["train"]["loss"] for h in solver.history]
    info = {"command": "python -m demucs_tpu_torch.train " + " ".join(argv),
            "entry_point_s": entry_s, "repitch_backend": wrapper.backend,
            "dataset": type(wrapper).__name__, "default_repitch_proba": probas[0],
            "train_loss_by_epoch": losses,
            "valid_loss_by_epoch": [h["valid"]["loss"] for h in solver.history],
            "data_wait_by_epoch": waits,
            "data_wait_s_by_proba": {p: statistics.mean(w["load_s"] for w in waits
                                                        if w["repitch_proba"] == p)
                                     for p in sorted(set(probas))},
            "step_s_by_epoch": [w["step_s"] for w in waits],
            "batch_loop_profile": {p: {k: v[k] for k in ("wall_ms", "device_ms", "idle_share")}
                                   for p, v in idle.items()},
            "repitch_ms_per_11s_item_by_pitch": per_pitch,
            "repitch_ms_per_11s_item_mean": statistics.mean(per_pitch.values()),
            "repitched_item_shape": list(out.shape), "launches": counts}
    info["ok"] = (isinstance(wrapper, RepitchedWrapper) and probas[0] == 0.2
                  and len(solver.history) == 4 and all(math.isfinite(x) for x in losses)
                  and launched and out.shape[-1] >= int(0.88 * item.shape[-1])
                  and all(w["repitched_items"] == w["batches"] * ENTRY_BATCH
                          for w in waits if w["repitch_proba"] == 1.0))
    del solver, wrapper
    torch.cuda.empty_cache()
    return info, counts


def _median_step_ms(step, steps: int = RECIPE_STEPS) -> tp.Tuple[float, list]:
    import statistics

    import torch

    walls, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = step()
        losses.append(m["loss"].item())
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls[1:]), losses


def recipe_options(workdir: Path) -> tp.Tuple[dict, dict]:
    """The released HTDemucs at batch ENTRY_BATCH (7.8 s): the plain train
    step, the step with the SVD penalty (low-rank, then the power method),
    with DiffQ and with QAT at 8 bits, RECIPE_STEPS each, launches counted
    per option; the exact penalty on the card against the CPU's (and the
    low-rank one from the same probes); each quantized export written as a
    .dmx, read back through Separator on the card and held against the
    float model on a 10 s track (SER)."""
    import torch

    from demucs_tpu_torch.api import Separator
    from demucs_tpu_torch.train.config import TrainArgs
    from demucs_tpu_torch.train.solver import Solver
    from demucs_tpu_torch.train.step import train_step
    from demucs_tpu_torch.train.svd import SvdPenalty, svd_total
    from demucs_tpu_torch.zoo.native import save_model

    model = _released_training_model(seed=5)
    model.module.to("cuda")
    sources = 0.2 * torch.randn(ENTRY_BATCH, 4, 2, model.cfg.training_length, device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(7))
    gen = torch.Generator().manual_seed(8)
    paths: dict = {}
    info: dict = {"batch": ENTRY_BATCH, "segment_s": TRAIN_SEGMENT}

    def run(name: str, **kw) -> tp.Tuple[float, list]:
        opt = _optimizer(model, 3e-4)
        _zero_train_counts()
        ms, losses = _median_step_ms(lambda: train_step(model, opt, sources, generator=gen,
                                                        **kw))
        paths[name] = _read_train_counts()
        return ms, losses

    info["plain_step_ms"], _ = run("train plain")
    args = TrainArgs()
    args.svd.penalty = 1e-4
    for powm in (False, True):
        args.svd.powm = powm
        svd = SvdPenalty.from_args(args, model.kind, model.cfg)
        ms, losses = run("train svd " + ("powm" if powm else "lowrank"), svd=svd)
        with torch.no_grad():
            penalty = svd(dict(model.module.named_parameters()), gen).item()
        info["svd_" + ("powm" if powm else "lowrank")] = {
            "step_ms": ms, "over_plain": ms / info["plain_step_ms"], "losses": losses,
            "penalty": penalty}
    params = {n: p.detach() for n, p in model.module.named_parameters()}
    cpu_params = {n: p.cpu() for n, p in params.items()}
    with torch.no_grad():
        t0 = time.perf_counter()
        card = svd_total(params, exact=True).item()
        card_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        cpu = svd_total(cpu_params, exact=True).item()
        cpu_ms = (time.perf_counter() - t0) * 1e3
        low_card = svd_total(params, generator=torch.Generator().manual_seed(9)).item()
        low_cpu = svd_total(cpu_params, generator=torch.Generator().manual_seed(9)).item()
    info["svd_exact"] = {"card": card, "cpu": cpu, "rel_diff": abs(card - cpu) / abs(cpu),
                         "tol": SVD_RTOL, "card_ms": card_ms, "cpu_ms": cpu_ms,
                         "lowrank_card": low_card, "lowrank_cpu": low_cpu,
                         "lowrank_rel_diff": abs(low_card - low_cpu) / abs(low_cpu)}
    folder = workdir / "recipe_zoo"
    folder.mkdir(parents=True, exist_ok=True)
    wav = _track(10.0, 8)
    for mode, key, value in (("diffq", "quant.diffq", 1e-4), ("qat", "quant.qat", 8)):
        args = TrainArgs()
        setattr(args.quant, key.split(".")[1], value)
        opt = _optimizer(model, 3e-4)
        solver = Solver({}, model, opt, args, workdir / f"recipe_{mode}")
        quantizer = solver.quantizer
        _zero_train_counts()
        ms, losses = _median_step_ms(lambda: train_step(model, opt, sources, generator=gen,
                                                        quantizer=quantizer))
        paths[f"train {mode}"] = _read_train_counts()
        qstate = solver.quantized_state()
        save_model(model, folder / f"{mode}.dmx", quantized_state=qstate)
        save_model(model, folder / f"{mode}_float.dmx", half=False)
        stems = {}
        for name in (mode, f"{mode}_float"):
            sep = Separator(name, repo=folder, shifts=0)
            stems[name] = _stems(sep, wav)
            del sep
        ser = _ser_db(stems[f"{mode}_float"], stems[mode])
        info[mode] = {"step_ms": ms, "over_plain": ms / info["plain_step_ms"], "losses": losses,
                      "model_size_mb": float(torch.as_tensor(quantizer.size_mb()).detach()),
                      "float_size_mb": sum(p.numel() for p in model.module.parameters()) * 4
                      / 2**20, "quantized_params": len(quantizer.names),
                      "klass": qstate["meta"]["klass"], "separated_10s_shape":
                      list(stems[mode].shape), "ser_db_vs_float": ser}
        del solver, quantizer, opt
    del model, sources
    torch.cuda.empty_cache()
    steps_ok = all(math.isfinite(x) for k in ("svd_lowrank", "svd_powm", "diffq", "qat")
                   for x in info[k]["losses"])
    launched = all(counts[name] > 0 for counts in paths.values()
                   for name in TRAIN_KERNELS if name != "stft_dft_backward")
    info["ok"] = {"steps_finite": steps_ok, "kernels_launched": launched,
                  "svd_card_vs_cpu": info["svd_exact"]["rel_diff"] <= SVD_RTOL
                  and info["svd_exact"]["lowrank_rel_diff"] <= SVD_RTOL,
                  "quantized_separate": all(
                      info[m]["separated_10s_shape"] == [4, 2, wav.shape[-1]]
                      and isinstance(info[m]["ser_db_vs_float"], float)
                      and info[m]["ser_db_vs_float"] >= QUANT_SER_MIN_DB
                      for m in ("diffq", "qat"))}
    return info, paths


def recipe_wav_reader(workdir: Path) -> dict:
    """The C++ WAV window reader against the Python reader on an 11 s
    four-stem window of the synthetic training set (ms each, bit-equal;
    then 8 windows on the loader's 4 threads), and its prefetcher's examples
    against read_wav_window."""
    import statistics
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from demucs_tpu_torch import audio as ta
    from demucs_tpu_torch import native

    track = workdir / "trainset" / "train" / "track0"
    files = [track / f"{s}.wav" for s in ("drums", "bass", "other", "vocals")]
    frames, offset = int(RECIPE_SEGMENT * SR), SR

    def native_read():  # as train/wav.py::Wavset reads an example
        out = np.empty((len(files), 2, frames), np.float32)
        for k, f in enumerate(files):
            native.read_wav_window(f, offset, frames, 2, out=out[k])
        return out

    def python_read():
        return np.stack([ta.convert_audio_channels(
            ta.read_wav(f, frame_offset=offset, num_frames=frames)[0], 2) for f in files])

    timed = {}
    for name, fn in (("native", native_read), ("python", python_read)):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        timed[name] = (statistics.median(times), out)
    equal = np.array_equal(timed["native"][1], timed["python"][1])
    threaded = {}
    with ThreadPoolExecutor(4) as pool:
        for name, fn in (("native", native_read), ("python", python_read)):
            t0 = time.perf_counter()
            list(pool.map(lambda _: fn(), range(8)))
            threaded[name] = (time.perf_counter() - t0) * 1e3
    total = native.wav_info(files[0])["frames"]
    offsets = (0, offset, total - frames // 2)  # the last runs past the end: zero tail
    worst = 0.0
    with native.NativePrefetcher(channels=2, frames=frames, sources=4, num_threads=4) as pf:
        for off in offsets:
            pf.add_job(files, off, mean=0.01, std=0.2)
        pf.start()
        for i, off in enumerate(offsets):
            want = (np.stack([native.read_wav_window(f, off, frames, 2) for f in files])
                    - 0.01) / 0.2
            worst = max(worst, float(np.abs(pf.get(i) - want).max()))
    info = {"window_s": RECIPE_SEGMENT, "native_ms": timed["native"][0],
            "python_ms": timed["python"][0], "python_over_native":
            timed["python"][0] / timed["native"][0], "bit_equal": equal,
            "eight_windows_4_threads_ms": threaded,
            "prefetcher_max_abs_err": worst, "prefetcher_tol": 1e-6}
    info["ok"] = equal and worst <= 1e-6
    return info


def phase_train_recipe(workdir: Path) -> dict:
    """The reference's default training recipe through the entry point
    (repitch at 0.2, 11 s windows), the data waits at repitch 0 / 0.2 / 1
    and ms per repitched item; the SVD penalty, DiffQ and QAT steps against
    the plain step, the exact penalty card vs CPU, the quantized exports
    separated through Separator; the C++ WAV reader against the Python one.
    Returns the launches of each path (the entry point's and each option's
    steps)."""
    import torch

    from demucs_tpu_torch.inference.engine import GRAPHS

    GRAPHS.clear()
    torch.cuda.empty_cache()
    start = time.perf_counter()
    info = {"phase": "train_recipe", "card": card_line()}
    with _fp32():
        info["entry_point"], counts = recipe_entry_point(workdir)
        info["options"], paths = recipe_options(workdir)
    info["wav_reader"] = recipe_wav_reader(workdir)
    info["wall_s"] = time.perf_counter() - start
    emit(info)
    bad = [k for k in ("entry_point", "wav_reader") if not info[k]["ok"]]
    bad += [k for k, v in info["options"]["ok"].items() if not v]
    if bad:
        raise AssertionError(f"train_recipe: {bad}")
    return dict(paths, **{"train recipe": counts})


# ---------------------------------------------------------------------------
# Export: the HTDemucs core as a torch.export artifact with K3 as the
# registered op, its runtime around K1 and K2, and the release export
# ---------------------------------------------------------------------------

EXPORT_SECONDS = 30.0  # the artifact runtime's track
EXPORT_RTOL = 1e-6  # the exported core against the eager forward_core, x peak (same kernels)
RUNTIME_RTOL = 1e-5  # the runtime's stems (and the fast artifact) against the eager path, x peak


def _op_list(program) -> dict:
    import collections

    return dict(collections.Counter(str(n.target) for n in program.graph.nodes
                                    if n.op == "call_function"))


def _rel_peak(got, want) -> float:
    import numpy as np

    got, want = (np.asarray(t.float().cpu() if hasattr(t, "cpu") else t, np.float64)
                 for t in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _export_one(model, folder: Path, name: str, device=None) -> tuple:
    """Export ``model``'s core (traced on ``device``), save it and load it on
    the card: (program, loaded core, seconds and size)."""
    from demucs_tpu_torch.export import core as C

    start = time.perf_counter()
    program = C.export_program(model, device)
    export_s = time.perf_counter() - start
    path = folder / f"{name}.pt2"
    start = time.perf_counter()
    C.save_core(program, model.cfg, path)
    save_s = time.perf_counter() - start
    start = time.perf_counter()
    core = C.load_core(path, model.device)
    load_s = time.perf_counter() - start
    ops = _op_list(program)
    return program, core, {"traced_on": str(device or model.device), "export_s": export_s,
                           "save_s": save_s, "load_s": load_s,
                           "artifact_MB": path.stat().st_size / 2**20,
                           "k3_nodes": ops.get("demucs_tpu_torch.flash_mha.default", 0),
                           "softmax_nodes": sum(n for op, n in ops.items() if "softmax" in op)}


def _runtime_run(core, cfg, mix) -> tuple:
    """separate_with_core on ``mix`` with every kernel count zeroed just
    before: (stems, seconds, launches)."""
    import torch

    from demucs_tpu_torch.export.run import separate_with_core
    from demucs_tpu_torch.inference.engine import KERNELS

    for kernel in KERNELS:
        kernel.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    stems = separate_with_core(core, cfg, mix)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    return stems, seconds, {k.__name__: k.launches for k in KERNELS}


def export_release(workdir: Path, xp: Path, device) -> dict:
    """release.py on the train phase's XP: the 8-hex sha256 name, the segment
    pinned to the trained one, every weight the checkpoint's in fp16."""
    import hashlib
    import pickle

    import numpy as np

    from demucs_tpu_torch.export.release import export_xp
    from demucs_tpu_torch.zoo.convert import flat_state
    from demucs_tpu_torch.zoo.native import load_native_model

    start = time.perf_counter()
    path = export_xp(xp, workdir / "release_models")
    export_s = time.perf_counter() - start
    with open(xp / "checkpoint.pkl", "rb") as f:
        package = pickle.load(f)
    state = package.get("best_state") or package["state"]
    model = load_native_model(path, device=device)
    got = flat_state(model.module)
    sha = hashlib.sha256(path.read_bytes()).hexdigest()[:8]
    info = {"dmx": path.name, "MB": path.stat().st_size / 2**20, "export_s": export_s,
            "segment": model.cfg.segment, "trained_segment": package["args"]["dset"]["segment"],
            "name_ok": path.name == f"{xp.name}-{sha}.dmx",
            "weights_fp16_equal": set(got) == set(state) and all(
                np.array_equal(got[k], np.asarray(v).astype(np.float16).astype(np.float32))
                for k, v in state.items())}
    info["ok"] = (info["name_ok"] and info["weights_fp16_equal"]
                  and info["segment"] == info["trained_segment"])
    return info


def phase_export(workdir: Path, xp: Path) -> dict:
    """The released HTDemucs's core exported on the card and on the CPU
    (moved to the card), saved and loaded; the artifact against the eager
    core; the runtime on a 30 s track (K1, K2 and K3's launches) against
    apply_model(shifts=0); the fast preset's artifact on K3's bf16 route;
    opcheck of the op on CUDA; one release export. Returns each run's
    launches (the export and export fast paths)."""
    import numpy as np
    import torch

    from demucs_tpu_torch.export.core import export_program
    from demucs_tpu_torch.inference.apply import apply_model
    from demucs_tpu_torch.inference.engine import GRAPHS
    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs
    from demucs_tpu_torch.models.registry import Model, reconfigured
    from demucs_tpu_torch.ops.spec import cac_pack, demucs_spec

    GRAPHS.clear()
    torch.cuda.empty_cache()
    start = time.perf_counter()
    folder = workdir / "export"
    folder.mkdir(parents=True, exist_ok=True)
    cfg = HTDemucsConfig(segment=TRAIN_SEGMENT, **RELEASED)
    module = init_htdemucs(cfg, seed=0, layer_scale=1.0, random_norms=True).eval()
    model = Model("htdemucs", cfg, module.cuda())
    info: dict = {"phase": "export", "card": card_line(), "segment_s": TRAIN_SEGMENT}
    program, core, info["card_traced"] = _export_one(model, folder, "core")
    cpu_program, cpu_core, info["cpu_traced"] = _export_one(model, folder, "core_cpu", "cpu")
    info["op_lists_equal"] = _op_list(program) == _op_list(cpu_program)

    wav = _track(EXPORT_SECONDS, 9)
    ref = wav.mean(axis=0)
    mix = ((wav - ref.mean()) / (ref.std() + 1e-8))[None].astype(np.float32)
    x = torch.from_numpy(np.ascontiguousarray(mix[..., :cfg.training_length])).to(model.device)
    with torch.inference_mode(), _fp32():
        mag = cac_pack(demucs_spec(x, cfg.nfft))
        want = model.module.forward_core(mag, x)
    info["core_vs_eager"] = {name: max(_rel_peak(g, w) for g, w in zip(c(mag, x), want))
                             for name, c in (("card_traced", core), ("cpu_traced", cpu_core))}
    del cpu_core, cpu_program

    segments = len(range(0, mix.shape[-1], int(0.75 * cfg.training_length)))
    _runtime_run(core, cfg, mix[..., :cfg.training_length])  # warm-up: one segment
    stems, seconds, launches = _runtime_run(core, cfg, mix)
    apply_model(model, mix, shifts=0, split=True)  # warm-up: the graphs' capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_stems = apply_model(model, mix, shifts=0, split=True)
    apply_s = time.perf_counter() - t0
    expected = {"stft_dft": segments, "istft_dft": segments,
                "flash_mha": k3_per_forward(cfg) * segments, "flash_mha_bf16": 0}
    info["runtime"] = {"segments": segments, "audio_s_per_s": EXPORT_SECONDS / seconds,
                       "apply_model_audio_s_per_s": EXPORT_SECONDS / apply_s,
                       "stems_vs_apply_model": _rel_peak(stems, ref_stems),
                       "launches": launches, "expected": expected,
                       "finite": bool(np.isfinite(stems).all())}

    fast = reconfigured(model, compute_dtype="bfloat16")
    fast_program, fast_core, info["fast"] = _export_one(fast, folder, "core_fast")
    info["fast"]["op_lists_equal"] = (_op_list(fast_program)
                                      == _op_list(export_program(fast, "cpu")))
    # cuDNN's default bf16 algorithms are not deterministic (the transposed
    # convolutions): two eager forwards differ, so the artifact is held
    # against the eager core under cuDNN's deterministic mode, and the
    # eager forward's own rerun gap is printed beside it.
    with torch.inference_mode():
        fast_want = fast.module.forward_core(mag, x)
        info["fast"]["eager_rerun"] = max(_rel_peak(g, w) for g, w in
                                          zip(fast.module.forward_core(mag, x), fast_want))
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        fast_want = fast.module.forward_core(mag, x)
        info["fast"]["core_vs_eager"] = max(_rel_peak(g, w)
                                            for g, w in zip(fast_core(mag, x), fast_want))
    fast_stems, fast_seconds, fast_launches = _runtime_run(fast_core, cfg, mix)
    fast_expected = dict(expected, flash_mha=0, flash_mha_bf16=expected["flash_mha"])
    info["fast"].update(audio_s_per_s=EXPORT_SECONDS / fast_seconds, launches=fast_launches,
                        expected=fast_expected, finite=bool(np.isfinite(fast_stems).all()))

    info["opcheck"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(1, n, 512, device=model.device, dtype=dtype)
                   for n in (1344, 2688, 2688))
        torch.library.opcheck(torch.ops.demucs_tpu_torch.flash_mha.default, (q, k, v, 8, None))
        info["opcheck"][str(dtype)] = "passed"  # opcheck raises on a failed check
    info["release"] = export_release(folder, xp, model.device)
    info["wall_s"] = time.perf_counter() - start
    emit(info)
    checks = {
        "k3_nodes": all(info[k]["k3_nodes"] == k3_per_forward(cfg) and not info[k]["softmax_nodes"]
                        for k in ("card_traced", "cpu_traced", "fast")),
        "op_lists_equal": info["op_lists_equal"] and info["fast"]["op_lists_equal"],
        "core_vs_eager": max(info["core_vs_eager"].values()) <= EXPORT_RTOL,
        "runtime_launches": launches == expected,
        "runtime_stems": info["runtime"]["finite"]
        and info["runtime"]["stems_vs_apply_model"] <= RUNTIME_RTOL,
        "fast_core_vs_eager": info["fast"]["core_vs_eager"] <= RUNTIME_RTOL,
        "fast_launches": fast_launches == fast_expected and info["fast"]["finite"],
        "release": info["release"]["ok"]}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"export: {bad}")
    return {"export": launches, "export fast": fast_launches}


PAR_BATCH = 8  # the data-parallel checks' global batch of the released HTDemucs
PAR_FAMILY_BATCH = 4  # HDemucs and Demucs v2 (A7.6)
PAR_STEPS = 2
PAR_LR = 1e-4
# a path against one process after PAR_STEPS Adam steps: each step's loss within
# TRAIN_RTOL, the last step's gradients within the train allowance, and the weights at
# most PAR_WEIGHTS_FACTOR x the gap of the plain step run twice in the same run, plus
# PAR_WEIGHTS_FLOOR. Adam's first steps move a weight by about lr whatever its gradient's
# size, so a gradient near zero can move it either way where two runs differ in the last
# bits. HTDemucs's plain and NCCL steps run under deterministic() (K3's dQ in key-block
# order), and its plain step run twice must be bit-equal; without it K3's atomic dQ sums
# made the two runs differ (PERF.md, C5). HDemucs and Demucs v2 on two ranks read 5.8e-3
# and 2.4e-3 x lr, their plain step bit-equal twice
PAR_WEIGHTS_FACTOR = 3.0
PAR_WEIGHTS_FLOOR = 1e-2 * PAR_LR
PAR_CPU_SECONDS = 0.5  # the families' card-vs-CPU step: a 0.5 s batch of 1 (the CPU's time)
PAR_ENTRY = ["dset.segment=2", "dset.shift=1", "model_segment=1", f"dset.samplerate={SR}",
             "batch_size=4",
             "max_batches=1", "augment.repitch.proba=0", "augment.remix.group_size=2",
             "misc.num_workers=2", "dset.use_musdb=false",
             "model_args={channels: 16, depth: 4, nfft: 2048, t_layers: 2, t_heads: 4, "
             f"t_dropout: {TRAIN_DROPOUT}}}"]
PAR_DEVICE = "cuda:0"  # the one card, named several times in the device lists
GLOO_TWO = ["-n", "2", "--devices", f"{PAR_DEVICE},{PAR_DEVICE}", "--backend", "gloo"]
NCCL_ONE = ["-n", "1"]  # one rank on the card under NCCL
PAR_NCCL = "nccl"  # the backend of the in-process group of one
RANK_MODULE = "chip_smoke"  # what the launcher runs on each rank (rank_task)


PAR_CACHE: tp.List[Path] = []  # where the seeded weights are kept between processes


def _par_model(kind: str, seed: int = 3):
    """A released-width model for training (every parameter fp32): HTDemucs at
    its 7.8 s segment, HDemucs (hdemucs_mmi's shape) and Demucs v2 fed 7.8 s
    windows; on the CPU. The seeded draws are made once and kept under
    ``PAR_CACHE`` (the ranks load what the main process drew)."""
    import torch

    from demucs_tpu_torch.models import demucs as D
    from demucs_tpu_torch.models import hdemucs as H
    from demucs_tpu_torch.models.registry import Model

    cached = PAR_CACHE[0] / f"{kind}_{seed}.pt" if PAR_CACHE else None
    if cached is not None and cached.is_file():
        return torch.load(cached, weights_only=False)  # the pickled Model: no constructor
    if kind == "htdemucs":
        model = _released_training_model(seed=seed)
    elif kind == "hdemucs":
        cfg = H.HDemucsConfig(**dict(HDEMUCS, segment=TRAIN_SEGMENT))
        model = Model(kind, cfg, H.init_hdemucs(cfg, seed, layer_scale=1.0, random_norms=True))
    else:
        cfg = D.DemucsConfig(**dict(DEMUCS, segment=TRAIN_SEGMENT))
        model = Model(kind, cfg, D.init_demucs(cfg, seed, layer_scale=1.0, random_norms=True))
    model.module.train()
    if cached is not None:
        tmp = cached.with_suffix(".tmp")
        torch.save(model, tmp)
        tmp.rename(cached)
    return model


def _par_sources(batch: int, seconds: float = TRAIN_SEGMENT, seed: int = 8):
    import torch

    return 0.2 * torch.randn(batch, 4, 2, int(round(seconds * SR)),
                             generator=torch.Generator().manual_seed(seed))


def par_steps(kind: str, device, batch: int, steps: int, lr: float, loss: str = "mse") -> dict:
    """``steps`` train steps of ``kind`` on this rank's rows of a global batch
    of ``batch`` (the whole of it without a process group): losses, each
    step's ms (CUDA events around the step), the peak memory above what was
    held before, the kernels' launches (counted from 0 over the steps), the
    weights after the steps and the gradients of the first and the last."""
    import torch

    from demucs_tpu_torch.models.registry import Model
    from demucs_tpu_torch.train import distrib
    from demucs_tpu_torch.train.step import train_step

    cpu = _par_model(kind)
    model = Model(kind, cpu.cfg, cpu.module.to(device))
    world, rank = distrib.world_size(), distrib.rank()
    per = batch // world
    sources = _par_sources(batch)[rank * per:(rank + 1) * per].to(device)
    optimizer = _optimizer(model, lr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _zero_train_counts()
    losses, ms = [], []
    first = None
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = train_step(model, optimizer, sources, loss=loss)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(m["loss"].item())
        if first is None:  # the gradients at the initial weights
            first = {n: p.grad.detach().cpu() for n, p in model.module.named_parameters()}
    out = {"kind": kind, "batch": per, "global_batch": batch, "losses": losses, "step_ms": ms,
           "median_step_ms": sorted(ms[1:] or ms)[len(ms[1:] or ms) // 2],
           "peak_above_held_GiB": (torch.cuda.max_memory_allocated() - held) / 2**30,
           "launches": _read_train_counts(),
           "params": {n: p.detach().cpu() for n, p in model.module.named_parameters()},
           "grads": {n: p.grad.detach().cpu() for n, p in model.module.named_parameters()},
           "first_grads": first}
    del model, optimizer, sources
    torch.cuda.empty_cache()
    return out


def par_flag_cost() -> dict:
    """HTDemucs's plain step (the parallel phase's model and batch, PAR_BATCH,
    Adam at PAR_LR) without torch.use_deterministic_algorithms and under it,
    on one model: each way a warm-up step, PAR_STEPS timed steps (CUDA
    events) and one profiled step; the device ms each kernel group gains
    under the flag. K3's backward is one group: what the flag costs a step
    beyond it is the other groups' gain."""
    import statistics

    import torch

    from demucs_tpu_torch.models.registry import Model
    from demucs_tpu_torch.train.step import train_step

    cpu = _par_model("htdemucs")
    model = Model("htdemucs", cpu.cfg, cpu.module.to(PAR_DEVICE))
    sources = _par_sources(PAR_BATCH).to(PAR_DEVICE)
    optimizer = _optimizer(model, PAR_LR)

    def step():
        train_step(model, optimizer, sources, loss="mse")

    out = {}
    for name, scope in (("without_flag", contextlib.nullcontext), ("under_flag", deterministic)):
        with scope():
            step()
            ms = []
            for _ in range(PAR_STEPS):
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                step()
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
            out[name] = {"step_ms": ms, "median_step_ms": statistics.median(ms),
                         "profile": _profile_step(step)}
    groups = set(out["without_flag"]["profile"]["by_group_ms"]) | set(
        out["under_flag"]["profile"]["by_group_ms"])
    out["group_gain_ms"] = dict(sorted(
        ((g, out["under_flag"]["profile"]["by_group_ms"].get(g, 0.0)
          - out["without_flag"]["profile"]["by_group_ms"].get(g, 0.0)) for g in groups),
        key=lambda kv: -abs(kv[1])))
    out["flag_over_without"] = (out["under_flag"]["median_step_ms"]
                                / out["without_flag"]["median_step_ms"] - 1)
    del model, optimizer, sources
    torch.cuda.empty_cache()
    return out


def _par_tp_input():
    import torch

    return torch.from_numpy(_track(TRAIN_SEGMENT, 90)[None])


def rank_task(task: str, folder: Path, entry: tp.Sequence[str] = ()) -> int:
    """One rank of the parallel phase, started by ``python -m
    demucs_tpu_torch.launcher ... --module chip_smoke -- --rank-task TASK DIR``:
    ``dp_gloo`` (two ranks on one card under Gloo: two steps at lr 0 of
    HTDemucs's rows, the second timed, PAR_STEPS steps of HDemucs and Demucs v2 at
    PAR_FAMILY_BATCH, and ``tp_forward`` of the released HTDemucs). Rank 0
    writes the results to ``DIR/rank0.pt``; every rank reports a fingerprint
    of its weights (all ranks hold the same after an all-reduce). Then, with
    ``entry`` overrides, the ranks train through the entry point's ``main``
    in the same process group (the parallel phase stops them after epoch 1)."""
    import torch
    import torch.distributed as dist

    from demucs_tpu_torch.models.htdemucs import precision_scope
    from demucs_tpu_torch.train import distrib

    from demucs_tpu_torch import distprobe

    begin = time.perf_counter()
    stages = {"imports": begin - _START}
    device = distrib.init()
    stages["init"] = time.perf_counter() - begin
    rank = distrib.rank()
    PAR_CACHE[:] = [folder.parent]
    if distprobe.check(device):  # the probe first: the group is wired
        return 1
    stages["probe"] = time.perf_counter() - begin
    out = {"world": distrib.world_size(), "device": str(device), "backend": dist.get_backend(),
           "stages_s": stages}
    torch.backends.cudnn.deterministic = True  # runs of the same step are compared
    with precision_scope(None):
        if task == "dp_gloo":
            out["htdemucs"] = par_steps("htdemucs", device, PAR_BATCH, 2, 0.0)
            stages["htdemucs"] = time.perf_counter() - begin
            for kind in ("hdemucs", "demucs"):
                out[kind] = par_steps(kind, device, PAR_FAMILY_BATCH, PAR_STEPS, PAR_LR)
                stages[kind] = time.perf_counter() - begin
            from demucs_tpu_torch.models.registry import Model
            from demucs_tpu_torch.parallel.tp import tp_forward

            cpu = _par_model("htdemucs")
            model = Model("htdemucs", cpu.cfg, cpu.module.to(device))
            model.module.eval()
            _zero_train_counts()
            start = time.perf_counter()
            out["tp"] = {"out": torch.from_numpy(tp_forward(model, _par_tp_input())),
                         "launches": _read_train_counts(), "wall_s": time.perf_counter() - start}
            stages["tp"] = time.perf_counter() - begin
        else:
            raise ValueError(f"unknown rank task {task!r}")
    prints = {k: float(sum(p.double().sum() for p in v["params"].values()))
              for k, v in out.items() if isinstance(v, dict) and "params" in v}
    out["fingerprints"] = prints
    if task == "dp_gloo":  # its HTDemucs step is held by its gradients alone
        del out["htdemucs"]["params"]
    everyone = [distrib.share(prints, src) for src in range(distrib.world_size())]
    out["ranks_agree"] = all(e == everyone[0] for e in everyone)
    if rank == 0:
        stages["done"] = time.perf_counter() - begin
        torch.save(out, folder / "rank0.pt")
    distrib.barrier()
    torch.backends.cudnn.deterministic = False
    if entry:
        from demucs_tpu_torch.train.train import main as train_main

        print("RANK_TASK_DONE", flush=True)
        train_main(list(entry))
    dist.destroy_process_group()
    return 0


def _probe(lines: list, ranks: int, backend: str) -> dict:
    """The probe's lines (``distprobe.check``, run first by every rank task)."""
    oks = [x.split("DISTPROBE_OK ")[1] for x in lines if "DISTPROBE_OK" in x]
    coll = {}
    for x in lines:
        if "DISTPROBE_COLLECTIVES" in x:
            rank_, text = x.split("DISTPROBE_COLLECTIVES ")[1].split(" ", 1)
            coll[rank_] = json.loads(text)
    return {"ok_lines": oks, "collectives": coll,
            "ok": len(oks) == ranks and all(f"backend={backend}" in x
                                            and f"device={PAR_DEVICE}" in x for x in oks)}


def _weights_gap(got: dict, want: dict) -> dict:
    import torch

    worst = max(got, key=lambda n: (got[n] - want[n]).abs().max().item())
    gap = (got[worst] - want[worst]).abs().max().item()
    return {"bit_equal": all(bool(torch.equal(got[n], want[n])) for n in want),
            "max_abs_diff": gap, "worst": worst, "over_lr": gap / PAR_LR}


def _grad_allowance(got: dict, want: dict) -> dict:
    """Each gradient against the reference's: error over TRAIN_GRAD_RTOL x its
    peak + TRAIN_GRAD_FLOOR x the largest peak (<= 1 passes)."""
    peak = max(g.abs().max().item() for g in want.values())
    over = {n: (got[n] - g).abs().max().item()
            / (TRAIN_GRAD_RTOL * g.abs().max().item() + TRAIN_GRAD_FLOOR * peak)
            for n, g in want.items()}
    name = max(over, key=over.get)
    return {"err_over_allowance": over[name], "worst": name, "n": len(over)}


def _against(got: dict, want: dict, twice: dict) -> dict:
    """A run of PAR_STEPS steps against the reference run, ``twice`` the gap
    of the reference run twice (PAR_STEPS's note)."""
    losses_err = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    out = {"losses_err": losses_err, "grads": _grad_allowance(got["grads"], want["grads"]),
           "weights": _weights_gap(got["params"], want["params"]),
           "weights_limit": PAR_WEIGHTS_FACTOR * twice["max_abs_diff"] + PAR_WEIGHTS_FLOOR,
           "plain_twice": twice}
    out["ok"] = (losses_err <= TRAIN_RTOL and out["grads"]["err_over_allowance"] <= 1
                 and out["weights"]["max_abs_diff"] <= out["weights_limit"]
                 and all(math.isfinite(x) for x in got["losses"]))
    return out


def _strip(run: dict) -> dict:
    return {k: v for k, v in run.items() if k not in ("params", "grads", "first_grads")}


def par_families_card_vs_cpu() -> dict:
    """A7.6: one step of the released HDemucs and Demucs v2 at batch 1 on
    PAR_CPU_SECONDS of audio (mse, lr 0), card against CPU as the train
    phase holds HTDemucs: loss within TRAIN_RTOL, each gradient within its
    allowance."""
    import torch

    from demucs_tpu_torch.models.registry import Model
    from demucs_tpu_torch.train.step import train_step

    out = {}
    sources = _par_sources(1, PAR_CPU_SECONDS, seed=9)
    for kind in ("hdemucs", "demucs"):
        cpu = _par_model(kind)
        card = Model(kind, cpu.cfg, copy.deepcopy(cpu.module).to(PAR_DEVICE))
        got = train_step(card, _optimizer(card, 0.0), sources.to(PAR_DEVICE),
                         loss=TRAIN_CHECK_LOSS)
        card_grads = {n: p.grad.cpu() for n, p in card.module.named_parameters()}
        start = time.perf_counter()
        want = train_step(cpu, _optimizer(cpu, 0.0), sources, loss=TRAIN_CHECK_LOSS)
        cpu_s = time.perf_counter() - start
        grads = {n: p.grad for n, p in cpu.module.named_parameters()}
        loss_err = abs(got["loss"].item() - want["loss"].item()) / abs(want["loss"].item())
        row = dict(_grad_allowance(card_grads, grads), loss=want["loss"].item(),
                   loss_err=loss_err, cpu_step_s=cpu_s)
        row["ok"] = loss_err <= TRAIN_RTOL and row["err_over_allowance"] <= 1
        out[kind] = row
        del card, cpu
        torch.cuda.empty_cache()
    return out


def _env() -> dict:
    import os

    return dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _launch_until(args: list, stop) -> tp.Tuple[list, float]:
    """The launcher with ``args``, stopped (SIGTERM: it stops its ranks) once
    ``stop(lines)`` holds -> (output lines, seconds)."""
    import signal

    start = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "demucs_tpu_torch.launcher", *args], cwd=ROOT,
                            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines: list = []
    for line in proc.stdout:
        lines.append(line.rstrip())
        if stop(lines):
            proc.send_signal(signal.SIGTERM)
            break
    proc.wait(timeout=60)
    proc.stdout.close()
    return lines, time.perf_counter() - start


def _said(lines: list, rank: int, text: str) -> bool:
    return any(x.startswith(f"[rank {rank}]") and text in x for x in lines)


def _epoch_1_written(lines: list) -> bool:
    """Rank 0 wrote epoch 1's checkpoint and both ranks logged its summary."""
    return _said(lines, 0, "Checkpoint written: epoch 1") and all(
        _said(lines, r, "Train Summary | Epoch 1") for r in range(2))


def par_entry_argv(workdir: Path) -> list:
    """The entry point's overrides: a small HTDemucs (PAR_ENTRY, t_dropout on),
    2 epochs, on a synthetic wav folder (two 5 s tracks: 4 windows each, two
    batches an epoch; a 3 s valid track)."""
    data = _train_folder(workdir / "par_trainset", train_s=5.0, valid_s=3.0)
    return [f"dset.wav={data}", f"dset.metadata={workdir / 'par_meta'}",
            f"out_dir={workdir / 'par_out'}", "epochs=2", *PAR_ENTRY]


def par_data_parallel(workdir: Path, entry: list) -> tp.Tuple[dict, dict, dict]:
    """The probe's NCCL rank through the launcher (started first, in the
    background). The released HTDemucs at a global batch of PAR_BATCH: world
    1 on NCCL (this process, a group of one) against the plain one-process
    step (PAR_STEPS Adam steps at PAR_LR), two
    ranks of PAR_BATCH / 2 on cuda:0 under Gloo against one process of
    PAR_BATCH (the gradients at the initial weights, mse); A7.6: HDemucs and
    Demucs v2, PAR_STEPS steps at PAR_FAMILY_BATCH in one process and on two
    ranks, and each card against the CPU. Each with its step ms and peak
    memory. The Gloo ranks then run the entry point's first run (``entry``),
    stopped after epoch 1. Returns the report, the launches of the parallel
    train paths and the first run's output."""
    import torch

    import torch.distributed as dist

    info: dict = {}
    plain = {}
    PAR_CACHE[:] = [workdir]
    # the probe's NCCL rank starts now: its start-up overlaps the steps below
    probe_start = time.perf_counter()
    probe = subprocess.Popen([sys.executable, "-m", "demucs_tpu_torch.launcher", *NCCL_ONE,
                              "--module", "demucs_tpu_torch.distprobe"], cwd=ROOT, env=_env(),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    with _fp32():
        cudnn_deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            with deterministic():  # C5: the plain step twice bit-equal
                plain["htdemucs"] = par_steps("htdemucs", PAR_DEVICE, PAR_BATCH, PAR_STEPS,
                                              PAR_LR)
                again = par_steps("htdemucs", PAR_DEVICE, PAR_BATCH, PAR_STEPS, PAR_LR)
                twice = {"htdemucs": _weights_gap(again["params"], plain["htdemucs"]["params"])}
                del again
                # world 1 on NCCL in this process: the step's data-parallel path
                # (the global batch's draws, the gradients' all-reduce) on the card
                dist.init_process_group(PAR_NCCL,
                                        init_method=f"file://{workdir / 'nccl_rdv'}",
                                        world_size=1, rank=0)
                try:
                    nccl = par_steps("htdemucs", PAR_DEVICE, PAR_BATCH, PAR_STEPS, PAR_LR)
                    nccl["backend"] = dist.get_backend()
                finally:
                    dist.destroy_process_group()
            info["htdemucs_flag_cost"] = par_flag_cost()
            for kind in ("hdemucs", "demucs"):
                plain[kind] = par_steps(kind, PAR_DEVICE, PAR_FAMILY_BATCH, PAR_STEPS, PAR_LR)
                again = par_steps(kind, PAR_DEVICE, PAR_FAMILY_BATCH, PAR_STEPS, PAR_LR)
                twice[kind] = _weights_gap(again["params"], plain[kind]["params"])
                del again
        finally:
            torch.backends.cudnn.deterministic = cudnn_deterministic
        info["families_card_vs_cpu"] = par_families_card_vs_cpu()
    torch.cuda.empty_cache()
    lines = probe.communicate(timeout=300)[0].splitlines()
    info["probes"] = {"nccl_world_1": dict(_probe(lines, 1, "nccl"), rc=probe.returncode,
                                           launcher_s=time.perf_counter() - probe_start)}
    info["probes"]["nccl_world_1"]["ok"] &= probe.returncode == 0
    row = dict(_against(nccl, plain["htdemucs"], twice["htdemucs"]),
               plain=_strip(plain["htdemucs"]),
               nccl_world_1=_strip(nccl), backend=nccl["backend"])
    row["deterministic"] = True
    row["ok"] = row["ok"] and nccl["backend"] == "nccl" and twice["htdemucs"]["bit_equal"]
    info["htdemucs_nccl_world_1"] = row
    folder = workdir / "par_dp_gloo"
    folder.mkdir(parents=True, exist_ok=True)
    args = GLOO_TWO + ["--module", RANK_MODULE, "--", "--rank-task", "dp_gloo", str(folder)]
    lines, secs = _launch_until(args + entry, _epoch_1_written)
    done = next((i for i, x in enumerate(lines) if "RANK_TASK_DONE" in x), None)
    if done is None or not (folder / "rank0.pt").is_file():
        raise AssertionError("parallel: dp_gloo ended before its results:\n"
                             + "\n".join(lines[-40:]))
    first_run = {"lines": lines[done:], "s": secs}
    gloo = torch.load(folder / "rank0.pt", weights_only=False)
    gloo["launcher_s"] = secs
    info["probes"]["gloo_two_on_cuda0"] = _probe(lines[:done], 2, "gloo")
    ref = plain["htdemucs"]
    row = {"gloo_rank0": _strip(gloo["htdemucs"]),
           "grads": _grad_allowance(gloo["htdemucs"]["grads"], ref["first_grads"]),
           "loss_err": abs(gloo["htdemucs"]["losses"][0] - ref["losses"][0]) / ref["losses"][0],
           "ranks_agree": gloo["ranks_agree"], "backend": gloo["backend"],
           "launcher_s_with_entry_run_1": gloo["launcher_s"], "stages_s": gloo["stages_s"]}
    row["ok"] = (gloo["backend"] == "gloo" and gloo["world"] == 2 and gloo["ranks_agree"]
                 and row["loss_err"] <= TRAIN_RTOL and row["grads"]["err_over_allowance"] <= 1)
    info["htdemucs_gloo_two_ranks"] = row
    for kind in ("hdemucs", "demucs"):
        one, two = plain[kind], gloo[kind]
        info[f"{kind}_two_ranks"] = dict(_against(two, one, twice[kind]), one_process=_strip(one),
                                         two_ranks=_strip(two))
    info["tp_run"] = gloo["tp"]
    launches = {"dp nccl world 1": nccl["launches"],
                "dp gloo rank 0": gloo["htdemucs"]["launches"],
                "tp forward rank 0": gloo["tp"]["launches"]}
    return info, launches, first_run


def par_entry_point(entry: list, first_run: dict) -> dict:
    """The entry point on two ranks on cuda:0 (Gloo): its first run (the
    ranks of the Gloo task, stopped by SIGTERM to the launcher once rank 0
    wrote epoch 1's checkpoint), then ``python -m demucs_tpu_torch.launcher``
    with the same overrides resumes for epoch 2. Only rank 0 writes; the
    epoch summaries are equal on both ranks."""
    start = time.perf_counter()
    second = subprocess.run([sys.executable, "-m", "demucs_tpu_torch.launcher", *GLOO_TWO, "--",
                             *entry], cwd=ROOT, env=_env(), capture_output=True, text=True,
                            timeout=600)
    resumed_s = time.perf_counter() - start
    log1 = first_run["lines"]
    log2 = (second.stdout + second.stderr).splitlines()
    lines = log1 + log2

    def by_rank(pattern):
        return {r: [x.split(pattern)[1] for x in lines
                    if x.startswith(f"[rank {r}]") and pattern in x] for r in range(2)}

    train = by_rank("Train Summary | ")
    written = by_rank("Checkpoint written: ")
    out = Path(next(x.split("=", 1)[1] for x in entry if x.startswith("out_dir=")))
    xps = list((out / "xps").iterdir()) if (out / "xps").is_dir() else []
    history = json.loads((xps[0] / "history.json").read_text()) if xps else []
    info = {"overrides": " ".join(entry), "first_run_s_with_the_task": first_run["s"],
            "resume_rc": second.returncode, "resume_run_s": resumed_s,
            "train_summaries": train, "checkpoints_by_rank": written, "epochs": len(history),
            "replayed_epoch_1": any("Replay | Epoch 1" in x for x in log2),
            "train_loss_by_epoch": [h["train"]["loss"] for h in history]}
    info["ok"] = (second.returncode == 0 and len(xps) == 1 and len(history) == 2
                  and train[0] == train[1] and len(train[0]) == 2
                  and written[0] == ["epoch 1", "epoch 2"] and written[1] == []
                  and info["replayed_epoch_1"]
                  and all(math.isfinite(x) for x in info["train_loss_by_epoch"]))
    if not info["ok"]:
        info["log_tail"] = lines[-40:]
    return info


def par_sharding(tp_run: dict) -> tp.Tuple[dict, dict]:
    """Segments and bag members over a device list naming cuda:0 more than
    once: ``sharded_apply_model`` over 2 entries on 30 s against the device
    engine; a 4-member bag over 2 (segments split: 4 members do not divide
    2) and 4 entries (one entry a member) against the sequential engine; launches against the
    forwards' prediction. ``tp_forward`` on two ranks (from the dp_gloo run)
    against the one-device forward."""
    import random

    import numpy as np
    import torch

    from demucs_tpu_torch.inference.engine import device_apply_model
    from demucs_tpu_torch.models.htdemucs import HTDemucsConfig, init_htdemucs
    from demucs_tpu_torch.models.registry import BagOfModels, Model
    from demucs_tpu_torch.parallel.sharded import sharded_apply_model

    info: dict = {}
    launches: dict = {}
    cfg = HTDemucsConfig(segment=7.8, **RELEASED)
    members = [Model("htdemucs", cfg, init_htdemucs(cfg, seed=20 + k, layer_scale=1.0,
                                                    random_norms=True).eval().to(PAR_DEVICE))
               for k in range(4)]
    counts = Counts(*(m.module for m in members))
    mix = _track(30.0, 41)[None]

    def run(model, devices, label):
        kw = dict(shifts=1, rng=random.Random(11))
        call = (lambda: sharded_apply_model(model, mix, devices=devices, **kw)) if devices \
            else (lambda: device_apply_model(model, mix, **kw))
        call()  # captures
        torch.cuda.synchronize()
        counts.zero()
        start = time.perf_counter()
        got = call()
        wall = time.perf_counter() - start
        read = counts.read()
        launches[label] = read["launches"]
        return got, dict(read, wall_s=wall, audio_s_per_s=30.0 / wall)

    want, info["one_device"] = run(members[0], None, "engine 30 s (reference)")
    got, info["segments_over_2"] = run(members[0], [PAR_DEVICE] * 2, "sharded 2 x cuda:0")
    peak = float(np.abs(want).max())
    info["segments_over_2"]["err_over_peak"] = float(np.abs(got - want).max()) / peak
    bag = BagOfModels(members)
    want, info["bag_sequential"] = run(bag, None, "bag sequential")
    peak = float(np.abs(want).max())
    for n in (2, 4):
        got, row = run(bag, [PAR_DEVICE] * n, f"bag over {n} x cuda:0")
        row["err_over_peak"] = float(np.abs(got - want).max()) / peak
        row["route"] = "fan-out" if n % 4 == 0 else "segments"
        info[f"bag_over_{n}"] = row
    module = _par_model("htdemucs").module.to(PAR_DEVICE).eval()
    with torch.inference_mode():
        one = module(_par_tp_input().to(PAR_DEVICE)).cpu()
    tp_err = ((tp_run["out"] - one).abs().max() / one.abs().max()).item()
    info["tp_forward_two_ranks"] = {"err_over_peak": tp_err, "tol": ENGINE_RTOL,
                                    "wall_s": tp_run["wall_s"], "launches": tp_run["launches"]}
    del members, bag, module
    torch.cuda.empty_cache()
    rows = [v for k, v in info.items() if k.startswith(("segments", "bag_over"))]
    info["ok"] = (all(r["err_over_peak"] <= ENGINE_RTOL and r["ok"] for r in rows)
                  and info["one_device"]["ok"] and info["bag_sequential"]["ok"]
                  and tp_err <= ENGINE_RTOL)
    return info, launches


def phase_parallel(workdir: Path) -> dict:
    """Parallelism on one card: the probe through the launcher (NCCL at world
    1, two Gloo ranks on cuda:0, where ``distprobe.check`` is the first thing
    the rank task runs), data-parallel training of the three
    families against one process, the entry point through the launcher
    killed and resumed, segments and bag members over a device list naming
    cuda:0 several times, ``tp_forward`` on two ranks. One card shows that
    the paths are right and what they cost on it; no number here says how
    the work scales over several cards. Returns the new paths' launches."""
    import torch

    from demucs_tpu_torch.inference.engine import GRAPHS

    GRAPHS.clear()
    torch.cuda.empty_cache()
    start = time.perf_counter()
    info = {"phase": "parallel", "card": card_line()}
    entry = par_entry_argv(workdir)
    info["data_parallel"], launches, first_run = par_data_parallel(workdir, entry)
    info["probes"] = info["data_parallel"].pop("probes")
    info["entry_point"] = par_entry_point(entry, first_run)
    info["sharding"], shard_launches = par_sharding(info["data_parallel"].pop("tp_run"))
    launches.update(shard_launches)
    info["wall_s"] = time.perf_counter() - start
    dp = info["data_parallel"]
    bad = [k for k, v in info["probes"].items() if not v["ok"]]
    bad += [k for k in ("htdemucs_nccl_world_1", "htdemucs_gloo_two_ranks", "hdemucs_two_ranks",
                        "demucs_two_ranks") if not dp[k]["ok"]]
    bad += [k for k, v in dp["families_card_vs_cpu"].items() if not v["ok"]]
    bad += [k for k in ("entry_point", "sharding") if not info[k]["ok"]]
    info["ok"] = not bad
    emit(info)
    if bad:
        raise AssertionError(f"parallel: {bad}")
    return launches



K3_PAIR_DIR = ROOT / "build" / "k3_pair"
# the instances whose SASS --k3-pair counts, each with what its last template
# argument (a bool) means
K3_PAIR_SASS = {"flash_mha_bf16_kernelILi64ELi128ELi3E": "dropout",
                "flash_mha_bf16_kernelILi64ELi128ELi2E": "dropout",
                "flash_mha_bf16_masked_kernelILi64ELi128ELi3E": "dropout",
                "flash_mha_kernelILi64ELi2E": "masked",
                # head dims 32 and 48, which no change to the head dim 128
                # instances may touch
                "flash_mha_bf16_kernelILi32ELi128ELi2E": "dropout",
                "flash_mha_bf16_kernelILi48ELi128ELi2E": "dropout",
                "flash_mha_bf16_masked_kernelILi48ELi64ELi3E": "dropout",
                "flash_mha_kernelILi32ELi2E": "masked",
                "flash_mha_kernelILi48ELi2E": "masked"}
# the other head dims' forwards --k3-pair times in turns: (head dim, heads)
K3_PAIR_DIMS = ((32, 16), (48, 8))
# the same for the unmasked backward's block kernels (their next argument: the
# deterministic order)
K3_PAIR_BWD_SASS = {"Bf16BwdILi64ELi2E": "ordered", "Bf16BwdILi64ELi1E": "ordered",
                    "F32BwdILi64E": "ordered"}
# K3's libraries --k3-pair builds from each tree (the masked backward's where the tree has it)
K3_PAIR_LIBS = ("flash_mha", "flash_mha_bwd", "flash_mha_bwd_masked")


def _sass_counts(cuobjdump: Path, so: Path, wanted: dict) -> tuple:
    """SASS opcode counts of each kernel of ``so`` whose mangled name holds a
    key of ``wanted`` (the key, then whether its next bool template argument,
    named by the value, is set) -> (counts, the kernels' SASS lines)."""
    import collections
    import re

    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                          text=True).stdout
    counts, current, kept = {}, None, []
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            current = next((k for k in wanted if k in fn.group(1)), None)
            if current:
                rest, flag = fn.group(1).split(current)[1], wanted[current]
                current += (f" {flag}" if rest.startswith("Lb1E")
                            else f" no {flag}" if rest.startswith("Lb0E") else "")
            continue
        op = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if current and op:
            counts.setdefault(current, collections.Counter())[op.group(1).split(".")[0]] += 1
            kept.append(f"{current} | {line.strip()}")
    return {k: dict(sorted(v.items())) for k, v in counts.items()}, kept


def _pair_build(trees: list) -> list:
    """nvcc of each tree's K3 libraries (K3_PAIR_LIBS that it has; the port's
    flags, each source's headers from its own tree, a library of several
    sources linked as _build links it), all at once, into K3_PAIR_DIR/<i>;
    the libraries loaded with the wrappers' ctypes declarations, and each
    one's ptxas report and the SASS opcode counts of K3_PAIR_SASS's and
    K3_PAIR_BWD_SASS's instances (their lines in K3_PAIR_DIR/<i>/sass.txt)."""
    import ctypes
    import shutil
    from unittest import mock

    from demucs_tpu_torch.kernels import _build
    from demucs_tpu_torch.kernels import attention as KA

    nvcc = _build.nvcc_path()
    jobs = []
    src_text = [(Path(tree) / "demucs_tpu_torch" / "csrc" / "flash_mha.cu").read_text()
                for tree in trees]
    for i, tree in enumerate(trees):
        out = K3_PAIR_DIR / str(i)
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        csrc = Path(tree) / "demucs_tpu_torch" / "csrc"
        for name in K3_PAIR_LIBS:
            if (csrc / f"{name}.cu").exists():
                jobs.append((i, name, out / f"lib{name}.so",
                             _build.Job(name, csrc, out / f"lib{name}.so", nvcc)))
    libs = [{} for _ in trees]
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    loaders = {"flash_mha": KA._lib, "flash_mha_bwd": KA._bwd_lib,
               "flash_mha_bwd_masked": KA._bwd_masked_lib}
    for i, name, so, job in jobs:
        report, error = job.finish()
        if error is not None:
            raise RuntimeError(f"tree {i}: {error}")
        lib = ctypes.CDLL(str(so))
        with mock.patch.object(_build, "load", lambda _name, lib=lib: lib):
            loaders[name].__wrapped__()  # the wrapper's argtypes on this library
        if name == "flash_mha" and "tile_map" not in src_text[i]:
            # a tree before the tile maps: its entries take the mask as bytes
            # (k3_forward calls them as its wrapper did)
            p, n, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.flash_mha_f32.argtypes = [p] * 7 + [n, n, n, n, n, f, n, f, n, p]
            lib.flash_mha_bf16.argtypes = [p] * 7 + [n, n, n, n, n, f, n, n, n, f, n, p]
            libs[i]["legacy"] = True
        elif name in K3_NEWER_ARGS:
            entry, marker, drop = K3_NEWER_ARGS[name]
            source = Path(trees[i]) / "demucs_tpu_torch" / "csrc" / f"{name}.cu"
            if marker not in source.read_text():
                lib = _OlderEntry(lib, entry, drop)
        libs[i][name] = lib
        libs[i][name + ".ptxas"] = report
        wanted = {"flash_mha": K3_PAIR_SASS, "flash_mha_bwd": K3_PAIR_BWD_SASS}.get(name)
        if wanted and cuobjdump.exists():
            counts, kept = _sass_counts(cuobjdump, so, wanted)
            libs[i].setdefault("sass", {}).update(counts)
            with open(K3_PAIR_DIR / str(i) / "sass.txt", "a") as f:
                f.write("\n".join(kept) + "\n")
    for lib in libs:
        # a tree before the masked backward's instances: its entries take the mask as bytes
        lib["bwd_legacy"] = "flash_mha_bwd_masked" not in lib
    return libs


# the C entries that gained arguments, by library: (entry, what its source
# names, the arguments' positions); a tree before them takes none of these
K3_NEWER_ARGS = {"flash_mha": ("flash_mha_bf16", "int row0", (19,)),  # a piece's first row
                 "flash_mha_bwd_masked": ("flash_mha_bwd_masked_f32", "fwd_map", (8, 9))}


class _OlderEntry:
    """A tree's library whose C entry ``entry`` predates the arguments at
    ``drop`` (K3_NEWER_ARGS): the wrappers' call without them, which must
    be 0 or null there (that tree has nothing of them); its other entries
    as they are."""

    def __init__(self, lib, entry: str, drop: tuple):
        self._lib, self._entry, self._drop = lib, entry, drop
        fn = getattr(lib, entry)
        fn.argtypes = [t for j, t in enumerate(fn.argtypes) if j not in drop]

    def __getattr__(self, name: str):
        fn = getattr(self._lib, name)
        if name != self._entry:
            return fn

        def call(*args):
            if any(args[j] for j in self._drop):
                raise ValueError(f"{name} of an older tree takes no arguments {self._drop}")
            return fn(*(a for j, a in enumerate(args) if j not in self._drop))
        return call


_LEGACY = None  # inside _pair_libs: a parent tree's library that takes the mask as bytes
_BWD_LEGACY = None  # the same for the backward: a tree before the masked instances


def k3_forward(route: str, q, k, v, num_heads: int, mask, rate: float = 0.0, seed: int = 0,
               want_lse: bool = False):
    """--k3-pair's launch of K3's forward on ``route`` ("bf16" or "f32") ->
    (o, lse): through the wrapper's launch with the keep-mask's tiles
    (``mask``: a ``(Tq, Tk)`` keep-mask on the card, or None), or, inside
    _pair_libs of a parent tree before the tile maps (whose kernels read the
    mask as a byte per score), through that tree's C entry as its wrapper
    called it (the plan of bf16_plan without a map, as the parent chose it)."""
    import torch

    from demucs_tpu_torch.kernels import _build
    from demucs_tpu_torch.kernels import attention as KA

    if _LEGACY is None:
        launch = KA._forward_bf16 if route == "bf16" else KA._forward_f32
        tiles = None if mask is None else KA.mask_tiles(mask)
        return launch(q, k, v, num_heads, tiles, rate, seed, want_lse)
    B, Tq, C = q.shape
    Tk, d = k.shape[1], C // num_heads
    keep = None if mask is None else mask.to(torch.uint8).contiguous().data_ptr()
    out = torch.empty_like(q)
    lse = torch.empty(B * num_heads, Tq, device=q.device) if want_lse else None
    lse_ptr, stream = None if lse is None else lse.data_ptr(), _build.stream_ptr(q.device)
    if route == "f32":
        image = torch.empty(B, num_heads, -(-Tk // KA.KEY_TILE), 4, KA.KEY_TILE * d,
                            device=q.device)
        status = _LEGACY.flash_mha_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), keep, image.data_ptr(), out.data_ptr(),
            lse_ptr, B, Tq, Tk, num_heads, d, KA.q_scale(d), KA.BLOCK_ROWS, rate,
            KA._int32(seed), stream)
    else:
        rows, ctas = KA.bf16_plan(B, Tq, Tk, num_heads, KA._sm_count(q.device.index or 0))
        n_tiles = -(-Tk // KA.KEY_TILE_BF16)
        part = None
        if KA._splits(KA._ranges(-(-Tq // rows) * num_heads * B * n_tiles, ctas), n_tiles):
            part = torch.empty(2 * ctas * rows * (d + 2), device=q.device)
        status = _LEGACY.flash_mha_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), keep, out.data_ptr(),
            None if part is None else part.data_ptr(), lse_ptr, B, Tq, Tk, num_heads, d,
            KA.q_scale(d), KA.KEY_TILE_BF16, rows, ctas, rate, KA._int32(seed), stream)
    KA._check_launch(status, f"{route} forward of the parent tree")
    return out, lse


def k3_backward(route: str, q, k, v, o, do, num_heads: int, lse, mask, rate: float = 0.0,
                seed: int = 0):
    """--k3-pair's launch of K3's backward on ``route`` ("bf16" or "f32") ->
    (dq, dk, dv): through the wrapper (``mask``: a ``(Tq, Tk)`` keep-mask on
    the card, or None; the masked instances read its tiles), or, inside
    _pair_libs of a tree before the masked instances (whose kernel read the
    mask as a byte per score), through that tree's C entry as its wrapper
    called it."""
    import torch

    from demucs_tpu_torch.kernels import _build
    from demucs_tpu_torch.kernels import attention as KA

    backward = KA.flash_mha_bwd_bf16 if route == "bf16" else KA.flash_mha_bwd
    if _BWD_LEGACY is None or mask is None:
        return backward(q, k, v, o, do, num_heads, lse=lse, mask=mask, dropout=rate,
                        dropout_seed=seed)
    B, Tq, C = q.shape
    Tk, d = k.shape[1], C // num_heads
    keep = mask.to(torch.uint8).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty(B * num_heads * -(-Tq // 64) * 128, device=q.device)
    dq_acc = torch.empty(B * num_heads * -(-Tq // 64) * 64 * d, device=q.device)
    turns = KA.dq_turns(B, num_heads, Tq, q.device)
    keys = (KA.bwd_keys(B, Tk, num_heads, KA._sm_count(q.device.index or 0))
            if route == "bf16" else 64)
    entry = "flash_mha_bwd_bf16" if route == "bf16" else "flash_mha_bwd_f32"
    status = getattr(_BWD_LEGACY, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        keep.data_ptr(), stats.data_ptr(), dq_acc.data_ptr(),
        None if turns is None else turns.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Tq, Tk, num_heads, d, keys, KA.q_scale(d), 1.0 / math.sqrt(d), float(rate),
        KA._int32(KA._seed32(rate, seed)), _build.stream_ptr(q.device))
    KA._check_launch(status, f"{route} backward of the parent tree")
    return dq, dk, dv


@contextlib.contextmanager
def _pair_libs(libs: dict):
    """The K3 wrappers on one tree's libraries inside the block (k3_forward
    on a tree before the tile maps: its own entries' arguments)."""
    from unittest import mock

    from demucs_tpu_torch.kernels import attention as KA

    def legacy(route):  # the wrappers' unmasked launches on a tree before the tile maps
        def launch(q, k, v, num_heads, tiles, rate, seed, want_lse, head_dim=None):
            if tiles is not None:
                raise ValueError("a tree before the tile maps: mask through k3_forward")
            return k3_forward(route, q, k, v, num_heads, None, rate, seed, want_lse)
        return launch

    global _LEGACY, _BWD_LEGACY
    _LEGACY = libs["flash_mha"] if libs.get("legacy") else None
    _BWD_LEGACY = libs["flash_mha_bwd"] if libs.get("bwd_legacy") else None
    routes = ({"_forward_bf16": legacy("bf16"), "_forward_f32": legacy("f32")}
              if _LEGACY is not None else {})
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(KA, "_lib", lambda: libs["flash_mha"]))
            stack.enter_context(mock.patch.object(KA, "_bwd_lib", lambda: libs["flash_mha_bwd"]))
            if "flash_mha_bwd_masked" in libs:
                stack.enter_context(mock.patch.object(KA, "_bwd_masked_lib",
                                                      lambda: libs["flash_mha_bwd_masked"]))
            for name, launch in routes.items():
                stack.enter_context(mock.patch.object(KA, name, launch))
            yield
    finally:
        _LEGACY = _BWD_LEGACY = None


def _under_flag(fn):
    """``fn`` called under deterministic()."""
    def call():
        with deterministic():
            return fn()
    return call


def k3_pair(trees: list, libs: list) -> dict:
    """K3's forwards and backwards at dropout 0 and TRAIN_DROPOUT (the
    backwards also under deterministic(), the ordered instances), built from
    each of ``trees`` (checkouts: the parent's ``git archive`` beside this
    one, or a variant's copy) and timed in turns in one process on one card:
    tree order, then reversed (parent, change, change, parent for two), at
    the transformer's four shapes x B = 1 / 8, each tree's time the mean of
    its two readings. Also each tree's drop pattern against dropout_keep on
    the bf16 route (_drop_pattern_mismatches), its output against the first
    tree's, the bf16 plans at TRAIN_DROPOUT at freq self, ptxas's registers
    and spills of the bf16 instances and of the unmasked backward's, the
    SASS opcode counts of K3_PAIR_SASS's and K3_PAIR_BWD_SASS's instances
    (their lines in K3_PAIR_DIR/<i>/sass.txt) and whether each equals the
    first tree's, and each case's last tree over first tree time range.
    ``libs``: the trees' libraries (_pair_build)."""
    import torch

    from demucs_tpu_torch.kernels import attention as KA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    C, H = 512, 8
    tokens = {"freq": 2688, "time": 1344}
    order = list(range(len(trees))) + list(reversed(range(len(trees))))
    rows = {}
    for batch in (1, 8):
        for tq_name, tk_name in (("freq", "freq"), ("time", "time"), ("freq", "time"),
                                 ("time", "freq")):
            Tq, Tk = tokens[tq_name], tokens[tk_name]
            q, k, v, do = (torch.randn(batch, T, C, device=dev, generator=gen)
                           for T in (Tq, Tk, Tk, Tq))
            qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
            ob, lseb = KA._forward_bf16(qb, kb, vb, H, None, 0.0, 0, True)
            of, lsef = KA._forward_f32(q, k, v, H, None, 0.0, 0, True)
            cases = {
                "bf16_fwd": lambda: KA._forward_bf16(qb, kb, vb, H, None, 0.0, 0, False)[0],
                "bf16_fwd_dropout": lambda: KA._forward_bf16(qb, kb, vb, H, None,
                                                             TRAIN_DROPOUT, 5, False)[0],
                "f32_fwd": lambda: KA._forward_f32(q, k, v, H, None, 0.0, 0, False)[0],
                "f32_fwd_dropout": lambda: KA._forward_f32(q, k, v, H, None, TRAIN_DROPOUT,
                                                           5, False)[0],
                "bf16_bwd_dropout": lambda: KA.flash_mha_bwd_bf16(
                    qb, kb, vb, ob, dob, H, lse=lseb, dropout=TRAIN_DROPOUT, dropout_seed=5),
                "f32_bwd_dropout": lambda: KA.flash_mha_bwd(
                    q, k, v, of, do, H, lse=lsef, dropout=TRAIN_DROPOUT, dropout_seed=5)}
            # the unmasked backwards at dropout 0, and each also under the flag (the
            # deterministic order's instances)
            cases["bf16_bwd"] = lambda: KA.flash_mha_bwd_bf16(qb, kb, vb, ob, dob, H, lse=lseb)
            cases["f32_bwd"] = lambda: KA.flash_mha_bwd(q, k, v, of, do, H, lse=lsef)
            for name in ("bf16_bwd", "f32_bwd", "bf16_bwd_dropout", "f32_bwd_dropout"):
                cases[f"{name}_deterministic"] = _under_flag(cases[name])
            key = f"B={batch} {tq_name}<-{tk_name}"
            times = {name: [[] for _ in trees] for name in cases}
            for i in order:
                with _pair_libs(libs[i]):
                    for name, fn in cases.items():
                        times[name][i].append(cuda_ms(fn))
            row = {name: [sum(t) / len(t) for t in per] for name, per in times.items()}
            row["readings"] = times
            first = None
            diffs, patterns = [], []
            for i in range(len(trees)):
                with _pair_libs(libs[i]):
                    got = cases["bf16_fwd_dropout"]().float()
                    patterns.append(_drop_pattern_mismatches(qb, kb, H, TRAIN_DROPOUT,
                                                             77 + batch))
                first = got if first is None else first
                diffs.append((got - first).abs().max().item())
            row["bf16_dropout_max_abs_diff_to_tree_0"] = diffs
            row["drop_pattern_mismatches"] = patterns
            rows[key] = row
            del q, k, v, do, qb, kb, vb, dob, ob, lseb, of, lsef
            torch.cuda.empty_cache()
    sweep = {}
    for batch in (1, 8):
        q, k, v = (torch.randn(batch, 2688, C, device=dev, generator=gen).bfloat16()
                   for _ in range(3))
        for i in range(len(trees)):
            with _pair_libs(libs[i]):
                for bk, r, persistent in BF16_PLANS:
                    with bf16_plan(KEY_TILE_BF16=bk, BF16_ROWS=r, BF16_PERSISTENT=persistent):
                        sweep.setdefault(f"B={batch} freq<-freq tree {i}", {})[
                            f"{bk} keys {r} rows {'persistent' if persistent else 'grid'}"] = \
                            cuda_ms(lambda: KA._forward_bf16(q, k, v, H, None, TRAIN_DROPOUT, 5,
                                                             False)[0])
    # the forwards at head dims 32 and 48, unmasked and under the diag mask
    from demucs_tpu_torch.ops.sparse import keep_mask

    diag = keep_mask(2688, 2688, "diag", device=dev, **MASK_DEFAULTS)
    dims = {}
    for batch in (1, 8):
        for d, heads in K3_PAIR_DIMS:
            q, k, v = (torch.randn(batch, 2688, d * heads, device=dev, generator=gen)
                       for _ in range(3))
            qb, kb, vb = (t.bfloat16() for t in (q, k, v))
            cases = {
                "f32_fwd": lambda: k3_forward("f32", q, k, v, heads, None),
                "bf16_fwd": lambda: k3_forward("bf16", qb, kb, vb, heads, None),
                "f32_fwd_diag": lambda: k3_forward("f32", q, k, v, heads, diag),
                "bf16_fwd_diag": lambda: k3_forward("bf16", qb, kb, vb, heads, diag)}
            times = {name: [[] for _ in trees] for name in cases}
            for i in order:
                with _pair_libs(libs[i]):
                    for name, fn in cases.items():
                        times[name][i].append(cuda_ms(fn))
            dims[f"B={batch} freq<-freq d={d}"] = {
                name: [sum(t) / len(t) for t in per] for name, per in times.items()}
            del q, k, v, qb, kb, vb
            torch.cuda.empty_cache()
    instances = [bf16_instances(lib["flash_mha.ptxas"]) for lib in libs]
    ratios = {name: [min(r[name][-1] / r[name][0] for r in rows.values()),
                     max(r[name][-1] / r[name][0] for r in rows.values())]
              for name in next(iter(rows.values())) if name not in (
                  "readings", "bf16_dropout_max_abs_diff_to_tree_0", "drop_pattern_mismatches")}
    sass = [lib.get("sass") for lib in libs]
    dim_ratios = {name: [min(r[name][-1] / r[name][0] for r in dims.values()),
                         max(r[name][-1] / r[name][0] for r in dims.values())]
                  for name in next(iter(dims.values()))}
    info = {"phase": "k3_pair", "card": card_line(), "trees": [str(t) for t in trees],
            "order": order, "by_shape": rows, "last_over_first_tree": ratios,
            "other_dims": dims, "other_dims_last_over_first_tree": dim_ratios,
            "plan_sweep_dropout_ms": sweep, "bf16_instances": instances,
            "bwd_instances": [bwd_instances(r, lib["flash_mha_bwd.ptxas"])
                              for lib in libs for r in ("Bf16Bwd", "F32Bwd")],
            "sass_opcodes": sass,
            "sass_equal_to_tree_0": [{k: v == (sass[0] or {}).get(k) for k, v in (t or {}).items()}
                                     for t in sass]}
    emit(info)
    return info


@contextlib.contextmanager
def _fp32():
    """TF32 off for cuBLAS and cuDNN (the kernels' plain versions, the step)."""
    from demucs_tpu_torch.models.htdemucs import precision_scope

    with precision_scope(None):
        yield


def _has_museval() -> bool:
    try:
        import museval  # noqa: F401
    except ImportError:
        return False
    return True


def main() -> int:
    if sys.argv[1:2] == ["--rank-task"]:  # one rank of the parallel phase (rank_task)
        sys.path.insert(0, str(ROOT))
        return rank_task(sys.argv[2], Path(sys.argv[3]), sys.argv[4:])
    if sys.argv[1:2] == ["--entry-counts"]:  # a training entry point, its launches counted
        sys.path.insert(0, str(ROOT))
        return entry_counts(Path(sys.argv[2]), sys.argv[3], sys.argv[4:])
    if sys.argv[1:2] == ["--k3-pair"]:  # K3's kernels of several checkouts, timed in turns
        sys.path.insert(0, str(ROOT))
        phase_device()
        libs = _pair_build(sys.argv[2:])
        k3_pair(sys.argv[2:], libs)
        phase_sparse_kernels(pair=libs)
        return 0
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import demucs_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"chip_smoke: run from a checkout of the repo ({err})", file=sys.stderr)
        return 2
    import shutil

    begin = time.perf_counter()
    workdir = ROOT / "build" / "chip_smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        phase_device()
        rows = phase_kernels()
        rows += phase_sparse_kernels()["kernel_rows"]
        cpu_model = phase_model()
        serving, sep = phase_serving(cpu_model, workdir)
        phase_graphs(sep)
        phase_pipelined(sep)
        phase_wire(sep)
        phase_profile(sep)
        del sep
        phase_bag()
        paths = {"htdemucs": serving["engines"]["device"]["launches"]}
        for kind in ("hdemucs", "demucs"):
            info = phase_family(kind, workdir)
            paths[info["phase"]] = info["serving"]["engines"]["device"]["launches"]
        phase_wiener()
        zoo, zoo_dir, bag = phase_zoo(workdir)
        paths["repro_mdx_a bag"] = zoo["serving"]["engines"]["device"]["launches"]
        phase_engines(workdir, zoo_dir, bag)
        _, preset_paths = phase_presets(workdir)
        paths.update(preset_paths)
        phase_prewarm(workdir)
        phase_codecs(workdir)
        phase_automix(workdir)
        _, paths["serve"] = phase_serve(workdir)
        _, stream_paths = phase_streaming(workdir)
        paths.update(stream_paths)
        _, variant_paths = phase_variants(workdir)
        paths.update(variant_paths)
        head_rows, head_paths = phase_head_dims(workdir)
        rows += head_rows
        paths.update(head_paths)
        phase_memory(workdir)
        phase_evaluate(workdir)
        train_rows, train_paths = phase_train(workdir)
        rows += train_rows
        paths.update(train_paths)
        paths.update(phase_train_recipe(workdir))
        paths.update(phase_export(workdir, next((workdir / "train_out" / "xps").iterdir())))
        paths.update(phase_parallel(workdir))
        phase_cli(workdir, zoo_dir, bag)
    except Exception:  # noqa: BLE001 — report, then fail without the last line
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    kernels = []
    for row in rows:
        # launches on each path (Separator's default serving and each preset, the
        # device engine, counted from 0 over that path's requests); "launches" is
        # their sum
        by_path = {path: counts.get(row["name"], 0) for path, counts in paths.items()}
        row = dict(row, route="cuda", launches=sum(by_path.values()))
        kernels.append(dict({k: row[k] for k in keys}, launches_by_path=by_path,
                            hdemucs_44s=row.get("hdemucs_44s"),
                            deterministic_ms=row.get("deterministic_ms"),
                            deterministic_max_abs_err=row.get("deterministic_max_abs_err")))
    emit({"phase": "total", "script_s": time.perf_counter() - begin})
    emit({"kernels": kernels})
    if not all(math.isfinite(k["ms"]) for k in kernels):
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
