"""Experiment grids: declarative hyperparameter sweeps (port of
``demucs_tpu/grids``; behavioral reference ``demucs/grids/*.py``, Dora
explorers).

A grid is a function returning a list of override dicts for
``demucs_tpu_torch.train.config.TrainArgs``, the JAX package's grids entry for
entry; each entry is one ``python -m demucs_tpu_torch.train key=value ...``
run with one XP signature. ``python -m demucs_tpu_torch.grids NAME`` prints
the entries and their signatures, ``--run``/``--status``/``--sbatch`` run,
monitor or submit them (:func:`main`).
"""

from __future__ import annotations

import typing as tp

Grid = tp.List[tp.Dict[str, tp.Any]]


def _merged(*dicts: dict) -> dict:
    out: dict = {}
    for d in dicts:
        out.update(d)
    return out


# The htdemucs training base (grids/mmi.py's launcher.bind_), shared by
# mmi and the mmi_ft continuations (the reference rebinds each base XP's
# full argv via get_xp_from_sig before fine-tuning).
_MMI_BASE = {
    "dset": "extra_mmi_goodclean",
    "test.shifts": 0,
    "model": "htdemucs",
    "model_args": {"dconv_mode": 3, "depth": 4, "t_dropout": 0.02,
                   "t_layers": 5},
    "max_batches": 800,
    "ema.epoch": (0.9, 0.95),
    "ema.batch": (0.9995, 0.9999),
    "dset.segment": 10,
    "batch_size": 32,
}


def mmi() -> Grid:
    """htdemucs training grid (grids/mmi.py): the recipe that produced the
    released hybrid-transformer models."""
    base = dict(_MMI_BASE)
    grid: Grid = []
    for t_layers in (5, 7):
        for bottom_channels in (0, 512):
            args = dict(base)
            args["model_args"] = _merged(
                base["model_args"], {"t_layers": t_layers, "bottom_channels": bottom_channels})
            grid.append(args)
    # hdemucs baselines from the same grid (mmi.py:31-33)
    for dset in ("extra_mmi_goodclean", "extra44", "musdb44"):
        grid.append(_merged(base, {"model": "hdemucs", "model_args": {},
                                   "dset": dset}))
    # the paper's sparse-attention variant (mmi.py:35-43; 9.20 dB claim)
    grid.append(_merged(base, {
        "batch_size": 24,
        "augment.remix.group_size": 3,
        "model_args": _merged(base["model_args"], {
            "t_auto_sparsity": True, "t_sparse_self_attn": True,
            "t_sparse_cross_attn": True, "t_sparsity": 0.9, "t_layers": 7}),
    }))
    return grid


def mmi_ft() -> Grid:
    """Per-source fine-tuning grid (grids/mmi_ft.py) — the htdemucs_ft recipe:
    one model per source with weights [0,..,1,..,0], lower lr, adamw+wd,
    grad clip, 50 epochs. The reference rebinds the base XP's full argv
    (get_xp_from_sig) before fine-tuning; here the mmi base config is merged
    in explicitly and the released weights come from the zoo
    (continue_pretrained)."""
    ft = _merged(_MMI_BASE, {
        "optim.lr": 1e-4,
        "augment.remix.proba": 0,
        "augment.scale.proba": 0,
        "augment.shift_same": True,
        "model_args": _merged(_MMI_BASE["model_args"],
                              {"t_weight_decay": 0.05}),
        "batch_size": 8,
        "optim.clip_grad": 5,
        "optim.optim": "adamw",
        "epochs": 50,
        "dset.wav2_valid": True,
        "ema.epoch": (),
        "continue_pretrained": "955717e8",
        "continue_best": True,
    })
    grid: Grid = []
    for segment in (10, 15):
        for source in range(4):
            w = [0.0] * 4
            w[source] = 1.0
            grid.append(_merged(ft, {"weights": tuple(w), "dset.segment": segment}))
    return grid


def repro() -> Grid:
    """Hybrid Demucs v3 paper reproduction (grids/repro.py): the v2
    baseline (360 epochs), and the 'newt' time-only + hybrid variants with
    the svd/base2 preset, each at seeds 42/43 (the repro_mdx_a bag)."""
    base = {"ema.epoch": (0.9, 0.95), "ema.batch": (0.9995, 0.9999),
            "epochs": 600}
    # conf/svd/base2.yaml + the grid's penalty binding (repro.py:27)
    svd = {"svd.penalty": 1e-5, "svd.min_size": 1, "svd.dim": 100,
           "svd.niters": 4, "optim.beta2": 0.9998}
    v2 = _merged(base, {"model": "demucs", "epochs": 360,
                        "model_args": {"dconv_mode": 0, "gelu": False,
                                       "lstm_layers": 2, "normalize": False}})
    newt = _merged(base, {"model": "demucs",
                          "model_args": {"normalize": True}})
    hdem = _merged(base, {"model": "hdemucs", "model_args": {}})
    grid: Grid = [v2]
    for variant in (newt, hdem):
        grid.append(_merged(variant, svd))
        grid.append(_merged(variant, svd, {"seed": 43}))
    return grid


def mdx() -> Grid:
    """MDX competition Track A recipe (grids/mdx.py + docs/training.md:
    Track A = time-only and hybrid 48/64-ch models on MusDB-HQ, segment 11,
    SVD penalty + residual branches + local attention for the time-only
    pair, CaC and mag+Wiener for the hybrid pair), each also launched with
    the DiffQ penalties that produced the ``mdx_q`` bag.

    The reference grid resolves each released signature's exact argv from
    its private Dora XP database (outputs.tar.gz); that genealogy is not
    portable, so this grid encodes the published recipe."""
    base = {
        "epochs": 360,
        "dset.segment": 11,
        "ema.batch": (0.9995,),
        "svd.penalty": 1e-5,
    }
    time_only = _merged(base, {
        "model": "demucs", "model_args": {"dconv_mode": 3}})
    hybrid_cac = _merged(base, {"model": "hdemucs", "model_args": {}})
    hybrid_wiener = _merged(base, {
        "model": "hdemucs",
        "model_args": {"cac": False, "wiener_iters": 0, "end_iters": 0}})
    bases = [time_only, _merged(time_only, {"seed": 43}), hybrid_cac,
             hybrid_wiener]
    grid: Grid = []
    for xp in bases:
        grid.append(xp)
        for diffq in (1e-4, 3e-4):  # the mdx_q quantized variants
            grid.append(_merged(xp, {"quant.diffq": diffq}))
    return grid


def mdx_extra() -> Grid:
    """MDX Track B recipe (grids/mdx_extra.py): the Track A bases retrained
    on the extra-data presets — ``dset=extra44`` and ``dset=extra_test``
    (musdb test folded into training) — with DiffQ variants on extra_test
    (the ``mdx_extra_q`` bag)."""
    grid: Grid = []
    for xp in mdx():
        if "quant.diffq" in xp:
            continue  # quant variants re-attached per-dset below
        for dset in ("extra44", "extra_test"):
            entry = _merged({"dset": dset}, xp)
            grid.append(entry)
            if dset == "extra_test":
                for diffq in (1e-4, 3e-4):
                    grid.append(_merged(entry, {"quant.diffq": diffq}))
    return grid


def mdx_refine(
    mdx_sigs: tp.Sequence[str] = ("<MDX_SIG_1>", "<MDX_SIG_2>",
                                  "<MDX_SIG_3>", "<MDX_SIG_4>"),
    mdx_q_sigs: tp.Optional[tp.Mapping[str, tp.Sequence[str]]] = None,
) -> Grid:
    """MDX fine-tuning round (grids/mdx_refine.py): each completed ``mdx``
    XP is continued on the automix set, plus DiffQ-quantized continuations.

    The quantized continuations must warm-start from the DIFFQ-TRAINED base
    XPs (the reference resolves ``base_argv + quant.diffq`` and asserts that
    XP completed — mdx_refine.py:25-33), not the unquantized base: pass
    ``mdx_q_sigs`` as ``{base_sig: (sig_diffq1e4, sig_diffq3e4)}``; entries
    default to ``<SIG>-q{diffq}`` placeholders to fill in."""
    refine = {
        "dset": "auto_mus",
        "continue_best": True,
        "optim.lr": 1e-4,
        "epochs": 4,
        "dset.segment": 28,
        "dset.shift": 2,
        "batch_size": 16,
        "ema.epoch": (0.9, 0.95),
        "ema.batch": (0.9995, 0.9999),
        "test.every": 1,
    }
    grid: Grid = []
    for sig in mdx_sigs:
        grid.append(_merged(refine, {"continue_from": sig}))
        for i, diffq in enumerate((1e-4, 3e-4)):
            q_sig = (mdx_q_sigs or {}).get(sig, (f"<{sig}-q1e-4>",
                                                 f"<{sig}-q3e-4>"))[i]
            grid.append(_merged(refine, {"continue_from": q_sig,
                                         "quant.diffq": diffq}))
    return grid


def sdx23() -> Grid:
    """SDX 2023 challenge grid (grids/sdx23.py): default htdemucs trained on
    the MoisesDB bleeding / labelnoise sets, musdb excluded."""
    return [
        {"dset": "sdx23_bleeding", "dset.use_musdb": False},
        {"dset": "sdx23_labelnoise", "dset.use_musdb": False},
    ]


def repro_ft(continue_from: str = "<REPRO_SIG>",
             automix_wav: str = "<AUTOMIX_OUT>") -> Grid:
    """Fine-tune a completed ``repro`` XP (grids/repro_ft.py): widened EMA
    banks, 4 epochs on the automix set (tools/automix.py output passed as
    the extra wav set — the reference binds dset=auto_mus) at segment 28,
    lr 1e-4, model_segment 44 (the released mdx_extra-era bag segment)."""
    return [{
        "continue_from": continue_from,
        "dset.wav": automix_wav,
        "ema.epoch": (0.9, 0.95),
        "ema.batch": (0.9995, 0.9999),
        "test.every": 1,
        "test.sdr": True,
        "epochs": 4,
        "dset.segment": 28,
        "dset.shift": 2,
        "augment.remix.proba": 0,
        "augment.scale.proba": 0,
        "augment.shift_same": True,
        "batch_size": 16,
        "optim.lr": 1e-4,
        "model_segment": 44,
    }]


GRIDS: tp.Dict[str, tp.Callable[[], Grid]] = {
    "mmi": mmi,
    "mmi_ft": mmi_ft,
    "repro": repro,
    "repro_ft": repro_ft,
    "mdx": mdx,
    "mdx_extra": mdx_extra,
    "mdx_refine": mdx_refine,
    "sdx23": sdx23,
}


def resolve(name: str, extra: tp.Optional[dict] = None) -> Grid:
    """Grid entries with ``dset=`` presets expanded and ``extra`` overrides
    merged in (the launcher analog of ``dora grid NAME key=value``)."""
    from demucs_tpu_torch.train.config import expand_presets

    out = []
    for overrides in GRIDS[name]():
        merged = _merged(overrides, extra or {})
        out.append(expand_presets(merged))
    return out


def _xp_status(args) -> str:
    """One-line XP state from its folder (the ``dora grid`` monitor column):
    epoch count + last train/valid loss + best, or 'not started'."""
    import json
    from pathlib import Path

    from demucs_tpu_torch.train.config import xp_signature

    folder = Path(args.out_dir) / "xps" / xp_signature(args)
    hist = folder / "history.json"
    if not hist.exists():
        return "not started"
    try:
        history = json.loads(hist.read_text())
    except (OSError, ValueError):
        return "unreadable history"
    if not history:
        return "epoch 0"
    last = history[-1]
    parts = [f"epoch {len(history)}/{args.epochs}"]
    if "train" in last:
        parts.append(f"train {last['train'].get('loss', float('nan')):.4f}")
    if "valid" in last:
        parts.append(f"valid {last['valid'].get('loss', float('nan')):.4f}")
        if "best" in last["valid"]:
            parts.append(f"best {last['valid']['best']:.4f}")
    return " ".join(parts)


def _run_subprocess(overrides: tp.Mapping[str, tp.Any]) -> int:
    """One XP as ``python -m demucs_tpu_torch.train key=value ...`` (isolated
    process, auto-resumes from its XP folder). Returns the exit code."""
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "demucs_tpu_torch.train"]
    cmd += [f"{k}={_yaml_value(v)}" for k, v in overrides.items()]
    return subprocess.run(cmd).returncode


#: Slurm directive defaults for ``--sbatch`` (the reference submits grids via
#: dora/submitit with conf/config.yaml:294-297 ``slurm: time: 4320 ...``;
#: site-specific keys such as its volta32gb constraint are given per site
#: with ``slurm.key=value`` tokens). One task per card: ``distrib.init`` puts
#: task k of a node on ``cuda:SLURM_LOCALID``, so give a node as many tasks
#: as cards (``slurm.ntasks-per-node=8 slurm.gpus-per-node=8``).
SBATCH_DEFAULTS: tp.Dict[str, tp.Any] = {
    "time": 4320,              # minutes (reference default)
    "nodes": 1,
    "ntasks-per-node": 1,      # one process per card
    "gpus-per-node": 1,        # every task of a node sees every card of it
    "cpus-per-task": 8,
}


def emit_sbatch(name: str, grid: Grid,
                directory, slurm: tp.Mapping[str, tp.Any]) -> list:
    """Write one sbatch submission script per grid entry into ``directory``
    and return the script paths.

    Fills the reference's grid-submission role (dora/submitit sweeps,
    conf/config.yaml:294-297, docs/training.md:45-83): each script is
    ``sbatch``-able as-is; at run time ``train.distrib.init`` reads the
    multi-task step (``SLURM_PROCID``, ``SLURM_STEP_NUM_TASKS``,
    ``SLURM_LOCALID``) and starts the process group over the allocated
    tasks."""
    import shlex
    import stat
    from pathlib import Path

    from demucs_tpu_torch.train.config import TrainArgs, apply_overrides, xp_signature

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    directives = dict(SBATCH_DEFAULTS)
    directives.update(slurm)
    paths = []
    for i, overrides in enumerate(grid):
        args = apply_overrides(TrainArgs(), dict(overrides))
        sig = xp_signature(args)
        tokens = [f"{k}={_yaml_value(v)}" for k, v in overrides.items()]
        lines = [
            "#!/bin/bash",
            f"#SBATCH --job-name=demucs_{name}_{sig}",
            f"#SBATCH --output={directory}/%x_%j.out",
        ]
        for key, value in directives.items():
            if value is None:
                continue
            lines.append(f"#SBATCH --{key}={value}")
        lines += [
            "",
            "set -e",
            # srun fans the command out to every allocated task; distrib.init
            # reads SLURM_* to join them into one process group.
            "srun python -m demucs_tpu_torch.train \\",
            "    " + " \\\n    ".join(shlex.quote(t) for t in tokens),
            "",
        ]
        path = directory / f"{name}_{i:02d}_{sig}.sbatch"
        path.write_text("\n".join(lines))
        path.chmod(path.stat().st_mode | stat.S_IXUSR | stat.S_IXGRP)
        paths.append(path)
    return paths


def main(argv=None, runner=_run_subprocess) -> None:
    """``python -m demucs_tpu_torch.grids NAME [--run N|all] [--jobs J] [--status]
    [--sbatch DIR] [key=value ...]`` — the local launcher/monitor analog of
    ``dora grid``; ``--sbatch`` emits Slurm submission scripts instead of
    running locally (``slurm.key=value`` tokens set/override #SBATCH
    directives, e.g. ``slurm.partition=gpu slurm.nodes=4``).

    Without flags: print every entry's XP signature and overrides (the
    ``dora grid NAME --dry_run`` analog). ``--run N``: execute entry N via
    the training entry point in-process (one XP, auto-resuming from its
    ``{out_dir}/xps/{sig}`` folder). ``--run all``: launch every entry as a
    subprocess, ``--jobs J`` of them concurrently (failures are reported at
    the end, remaining entries still run). ``--status``: print each entry's
    progress from its XP folder. Extra ``key=value`` tokens are merged into
    every entry (e.g. ``dset.musdb=/data/musdbhq out_dir=/xp``)."""
    import sys

    from demucs_tpu_torch.train.config import (
        TrainArgs, apply_overrides, parse_cli_overrides, xp_signature,
    )

    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in GRIDS:
        print(f"usage: python -m demucs_tpu_torch.grids {{{','.join(GRIDS)}}} "
              "[--run N|all] [--jobs J] [--status] [key=value ...]")
        raise SystemExit(1)
    name, rest = argv[0], argv[1:]
    run_index: tp.Optional[str] = None
    jobs = 1
    status = False
    if "--status" in rest:
        status = True
        rest.remove("--status")
    if "--jobs" in rest:
        at = rest.index("--jobs")
        jobs = int(rest[at + 1])
        rest = rest[:at] + rest[at + 2:]
    if "--run" in rest:
        at = rest.index("--run")
        run_index = rest[at + 1]
        rest = rest[:at] + rest[at + 2:]
    sbatch_dir = None
    if "--sbatch" in rest:
        at = rest.index("--sbatch")
        sbatch_dir = rest[at + 1]
        rest = rest[:at] + rest[at + 2:]
    slurm_tokens = [t for t in rest if t.startswith("slurm.")]
    bad = [t for t in slurm_tokens if "=" not in t]
    if bad:
        raise SystemExit(f"slurm directives need slurm.key=value, got: {bad}")
    if slurm_tokens and sbatch_dir is None:
        raise SystemExit(
            "slurm.* directives only apply with --sbatch DIR "
            f"(got: {slurm_tokens})")
    slurm = {t.split("=", 1)[0][len("slurm."):]: t.split("=", 1)[1]
             for t in slurm_tokens}
    rest = [t for t in rest if not t.startswith("slurm.")]
    extra = parse_cli_overrides([t for t in rest if "=" in t])
    grid = resolve(name, extra)

    if sbatch_dir is not None:
        paths = emit_sbatch(name, grid, sbatch_dir, slurm)
        for p in paths:
            print(p)
        print(f"wrote {len(paths)} sbatch scripts; submit with: "
              f"for f in {sbatch_dir}/{name}_*.sbatch; do sbatch $f; done")
        return

    if status:
        for i, overrides in enumerate(grid):
            args = apply_overrides(TrainArgs(), dict(overrides))
            print(f"[{i}] {xp_signature(args)}  {_xp_status(args)}")
        return

    if run_index is None:
        for i, overrides in enumerate(grid):
            args = apply_overrides(TrainArgs(), dict(overrides))
            print(f"[{i}]", xp_signature(args), overrides)
        return

    if run_index == "all":
        from concurrent.futures import ThreadPoolExecutor

        sigs = [xp_signature(apply_overrides(TrainArgs(), dict(ov)))
                for ov in grid]
        print(f"launching {len(grid)} XPs of grid {name!r} "
              f"({jobs} concurrent)", flush=True)
        with ThreadPoolExecutor(max_workers=max(1, jobs)) as pool:
            codes = list(pool.map(runner, grid))
        failed = [(i, sigs[i]) for i, code in enumerate(codes) if code != 0]
        for i, sig in failed:
            print(f"FAILED [{i}] {sig}", file=sys.stderr)
        print(f"grid {name!r}: {len(grid) - len(failed)}/{len(grid)} ok")
        if failed:
            raise SystemExit(1)
        return

    run_i = int(run_index)
    if not 0 <= run_i < len(grid):
        raise SystemExit(f"--run {run_i} out of range (grid has "
                         f"{len(grid)} entries)")
    overrides = grid[run_i]
    args = apply_overrides(TrainArgs(), dict(overrides))
    print(f"launching grid entry [{run_i}] sig={xp_signature(args)}:",
          overrides, flush=True)
    from demucs_tpu_torch.train.train import main as train_main

    train_main([f"{k}={_yaml_value(v)}" for k, v in overrides.items()])


def _yaml_value(value) -> str:
    import json

    if isinstance(value, tuple):
        value = list(value)
    if isinstance(value, (dict, list, bool)) or value is None:
        return json.dumps(value)
    if isinstance(value, str):
        # quoted: a released signature like "955717e8" would otherwise
        # round-trip through the CLI's exponent coercion into 9.55717e13
        return json.dumps(value)
    return str(value)
