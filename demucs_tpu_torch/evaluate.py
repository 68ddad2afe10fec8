"""Test-set evaluation: the MDX "new SDR" (nsdr), and BSS-eval through museval
when it is installed, else through the port's own ``ops/bsseval.py`` (port of
``demucs_tpu/evaluate.py``; behavioral reference ``demucs/evaluate.py``).

Separation runs through ``apply_model_tracks`` (the device engine on the
card, each track's copy of its stems overlapping the next track's compute);
the scores are computed on the host, in worker processes when
``args.test.workers`` is set. Tracks are shared round-robin between the
ranks of ``train/distrib.py``.

The test set is a MusdbHQ folder (``test/<track>/mixture.wav`` and a WAV per
stem); ``test.nonhq`` reads the compressed MUSDB's ``.stem.mp4`` files
through the multi-stream ``AudioFile`` instead (stream 0 the mixture, then
the SigSep stem order), which needs the libavcodec shim or ffmpeg.
"""

from __future__ import annotations

import logging
import typing as tp
from concurrent import futures
from pathlib import Path

import numpy as np

from demucs_tpu_torch import audio as ta
from demucs_tpu_torch.inference.apply import apply_model_tracks
from demucs_tpu_torch.train import distrib

__all__ = ["new_sdr", "eval_track", "evaluate", "MUSDB_STEM_STREAMS"]

logger = logging.getLogger(__name__)


def new_sdr(references: np.ndarray, estimates: np.ndarray) -> np.ndarray:
    """MDX-challenge SDR (evaluate.py:30-43): ``(B, S, C, T)`` -> ``(B, S)``."""
    assert references.ndim == 4 and estimates.ndim == 4
    delta = 1e-7
    num = np.sum(np.square(references), axis=(2, 3)) + delta
    den = np.sum(np.square(references - estimates), axis=(2, 3)) + delta
    return 10 * np.log10(num / den)


def eval_track(references: np.ndarray, estimates: np.ndarray, win: int, hop: int,
               compute_sdr: bool = True, flen: int = 512):
    """A track's scores -> ``(bss, nsdr)``: ``references`` and ``estimates``
    ``(S, C, T)``; nsdr ``(S,)`` always (in float64, as the reference casts
    before it, evaluate.py:106-110); with ``compute_sdr`` the BSS-eval images
    metrics ``(sdr, isr, sir, sar)``, each ``(S, frames)``, from museval
    where it is installed (the reference's configuration, evaluate.py:46-64),
    else from ``ops/bsseval.py`` in the same configuration; else None."""
    references_t = np.swapaxes(references, 1, 2).astype(np.float64)  # museval's (S, T, C)
    estimates_t = np.swapaxes(estimates, 1, 2).astype(np.float64)
    new_scores = new_sdr(references[None].astype(np.float64),
                         estimates[None].astype(np.float64))[0]
    if not compute_sdr:
        return None, new_scores
    try:
        import museval
    except ImportError:
        from demucs_tpu_torch.ops.bsseval import bss_eval_images

        return bss_eval_images(references_t, estimates_t, window=win, hop=hop,
                               flen=flen), new_scores
    scores = museval.metrics.bss_eval(
        references_t, estimates_t, compute_permutation=False, window=win, hop=hop,
        framewise_filters=False, bsseval_sources_version=False)[:-1]
    return scores, new_scores


def _iter_test_tracks(musdb_path: Path):
    test_dir = Path(musdb_path) / "test"
    if not test_dir.is_dir():
        raise FileNotFoundError(f"No test subset at {test_dir}")
    for track_dir in sorted(p for p in test_dir.iterdir() if p.is_dir()):
        yield track_dir.name, track_dir


# The SigSep stem layout of a .stem.mp4: stream 0 the mixture, then MUSDB's
# source order.
MUSDB_STEM_STREAMS = {"drums": 1, "bass": 2, "other": 3, "vocals": 4}


def _iter_test_tracks_nonhq(nonhq_path: Path):
    test_dir = Path(nonhq_path) / "test"
    if not test_dir.is_dir():
        raise FileNotFoundError(f"No test subset at {test_dir}")
    for p in sorted(test_dir.glob("*.stem.mp4")):
        yield p.name[: -len(".stem.mp4")], p


def _read_track_audio(track: Path, source: tp.Optional[str]):
    """The mixture (``source`` None) or a stem of ``track`` -> ``(wav, sr)``;
    ``track`` is a MusdbHQ track folder or a ``.stem.mp4`` file."""
    if track.is_dir():
        return ta.read_wav(track / f"{source or 'mixture'}.wav")
    if source is None:
        stream = 0
    else:
        try:
            stream = MUSDB_STEM_STREAMS[source]
        except KeyError:
            raise ValueError(
                f"source {source!r} has no stream in a MUSDB .stem.mp4 "
                f"(available: {sorted(MUSDB_STEM_STREAMS)})") from None
    af = ta.AudioFile(track)
    return af.read(streams=stream), af.samplerate(stream)


def evaluate(solver, compute_sdr: bool = False) -> tp.Dict[str, float]:
    """Test-set evaluation (evaluate.py:67-174) of ``solver.model`` (a port
    ``Model`` or ``BagOfModels``) over ``solver.args.dset.musdb``'s test
    tracks (or ``args.test.nonhq``), with ``args.test``'s ``shifts``,
    ``split``, ``overlap``, ``length_bucket_seconds``, ``workers`` and
    ``save`` (stems to ``solver.folder / "wav"``). Returns, per metric, the
    mean over sources of the per-source mean and median of the per-track
    medians, and each source's own (``nsdr``, ``nsdr_med``, ``nsdr_drums``,
    ...; with ``compute_sdr`` also ``sdr``, ``isr``, ``sir``, ``sar``)."""
    args = solver.args
    model = solver.model

    output_dir = solver.folder / "results"
    output_dir.mkdir(exist_ok=True, parents=True)

    win = int(1.0 * model.samplerate)
    hop = int(1.0 * model.samplerate)

    nonhq = getattr(args.test, "nonhq", None)
    if nonhq:
        track_list = list(_iter_test_tracks_nonhq(Path(nonhq)))
    else:
        track_list = list(_iter_test_tracks(args.dset.musdb))
    indexes = distrib.shard_indices(len(track_list))

    # meta is filled by the mixes' generator one track ahead of the stems
    # (the engine's pipeline is one track deep): meta[i] is there when the
    # stems of track i arrive
    meta: tp.List[tuple] = []

    def _mixes():
        for index in indexes:
            name, track_dir = track_list[index]
            mix, sr = _read_track_audio(track_dir, None)
            ref = mix.mean(axis=0)
            mean, std = ref.mean(), ref.std()
            mix = (mix - mean) / std
            mix = ta.convert_audio(mix, sr, model.samplerate, model.audio_channels)
            meta.append((name, track_dir, mean, std))
            yield mix[None]

    est_iter = apply_model_tracks(
        model, _mixes(), shifts=args.test.shifts, split=args.test.split,
        overlap=args.test.overlap, length_bucket_seconds=args.test.length_bucket_seconds)

    def _finish(i, estimates):
        name, track_dir, mean, std = meta[i]
        estimates = estimates[0] * std + mean
        refs = []
        for source in model.sources:
            wav, ssr = _read_track_audio(track_dir, source)
            refs.append(ta.convert_audio(wav, ssr, model.samplerate, model.audio_channels))
        references = np.stack(refs)
        if args.test.save:
            folder = solver.folder / "wav" / name
            folder.mkdir(exist_ok=True, parents=True)
            for sname, estimate in zip(model.sources, estimates):
                ta.save_audio(estimate, folder / (sname + ".wav"), model.samplerate)
        return name, references, estimates

    tracks: tp.Dict[str, dict] = {}
    if args.test.workers:
        pendings = []
        with futures.ProcessPoolExecutor(args.test.workers) as pool:
            for i, est in enumerate(est_iter):
                name, references, estimates = _finish(i, est)
                pendings.append((name, pool.submit(
                    eval_track, references, estimates, win=win, hop=hop,
                    compute_sdr=compute_sdr)))
            for name, pending in pendings:
                scores, nsdrs = pending.result()
                tracks[name] = _scores_dict(model.sources, scores, nsdrs)
    else:
        for i, est in enumerate(est_iter):
            name, references, estimates = _finish(i, est)
            scores, nsdrs = eval_track(references, estimates, win=win, hop=hop,
                                       compute_sdr=compute_sdr)
            tracks[name] = _scores_dict(model.sources, scores, nsdrs)

    all_tracks: tp.Dict[str, dict] = {}
    for src in range(distrib.world_size()):
        all_tracks.update(distrib.share(tracks, src))

    result: tp.Dict[str, float] = {}
    metric_names = next(iter(all_tracks.values()))[model.sources[0]]
    for metric_name in metric_names:
        avg = 0.0
        avg_of_medians = 0.0
        for source in model.sources:
            medians = [np.nanmedian(all_tracks[track][source][metric_name])
                       for track in all_tracks.keys()]
            mean = float(np.mean(medians))
            median = float(np.median(medians))
            result[metric_name.lower() + "_" + source] = mean
            result[metric_name.lower() + "_med" + "_" + source] = median
            avg += mean / len(model.sources)
            avg_of_medians += median / len(model.sources)
        result[metric_name.lower()] = avg
        result[metric_name.lower() + "_med"] = avg_of_medians
    return result


def _scores_dict(sources, scores, nsdrs) -> dict:
    out: tp.Dict[str, dict] = {}
    for idx, target in enumerate(sources):
        out[target] = {"nsdr": [float(nsdrs[idx])]}
    if scores is not None:
        (sdr, isr, sir, sar) = scores
        for idx, target in enumerate(sources):
            out[target].update({
                "SDR": sdr[idx].tolist(),
                "SIR": sir[idx].tolist(),
                "ISR": isr[idx].tolist(),
                "SAR": sar[idx].tolist(),
            })
    return out
