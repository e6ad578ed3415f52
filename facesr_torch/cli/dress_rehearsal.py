"""Full-curriculum dress rehearsal through the port's CLIs (the port of
`scripts/dress_rehearsal.sh`): the reference's stage 1 -> 2 -> 3 workflow at
reduced scale (60 + 25 + 12 epochs, HR 128) on synthetic faces, end to end:

    python -m facesr_torch.cli.dress_rehearsal [workdir] [--device cpu]

1. 608 synthetic faces at 160 (`cli.make_synthetic_faces`, seed 0);
2. `data.prepare_data` at HR 128 / LR 32, ``--hdf5 --train-ratio 0.84
   --val-ratio 0.08``: the PNG folders and ``train.h5``, ``val.h5`` and
   ``test.h5`` beside them (the port's own HDF5 writer, `data.hdf5`);
3. -5. the three stage YAMLs of ``configs/rehearsal`` through
   `cli.train` (``--no-wandb --yes``), which read ``train.h5`` and
   ``val.h5`` before the folders, each chained from the one before by
   its ``checkpoint.resume``; every ``/tmp/rehearsal`` in them is rewritten
   to the workdir in generated copies under ``<workdir>/configs``, so a
   workdir chains from its own checkpoints;
6. the stage plot is not drawn (it needs matplotlib, ROADMAP A.8.4: said
   and skipped); the three best checkpoints are copied to ``best_all/``,
   compared by `cli.compare_two_models` with the JAX script's flags, and
   stage 2 against stage 3 goes to `cli.stage_panel`.

``REHEARSAL_SETUP_ONLY=1`` stops after the configs are written. Training and
evaluation run on the card unless ``--device cpu`` is given, and raise
where there is no card. `rehearse` holds the steps; its arguments are the
workdir, the folder of stage YAMLs and the face count (the CLI passes the
JAX script's values; a smoke run passes cut copies).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["rehearse", "write_configs", "STAGES", "main"]

REPO = Path(__file__).resolve().parents[2]
STAGES = ("stage1_psnr", "stage2_ssim", "stage3_gan")
DEFAULT_WORK = "/tmp/rehearsal"
FACE_SIZE, HR_SIZE, LR_SIZE = 160, 128, 32


def write_configs(work: Path, config_dir: Path) -> Dict[str, Path]:
    """The stage YAMLs with every ``/tmp/rehearsal`` rewritten to
    ``work``, under ``work/configs``."""
    cfg = work / "configs"
    cfg.mkdir(parents=True, exist_ok=True)
    out = {}
    for name in STAGES:
        text = (config_dir / f"{name}.yaml").read_text()
        out[name] = cfg / f"{name}.yaml"
        out[name].write_text(text.replace(DEFAULT_WORK, str(work)))
    return out


def _check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} exited with {code}")


def rehearse(workdir: str = DEFAULT_WORK, config_dir: Optional[str] = None,
             num_faces: int = 608, device: Optional[str] = None) -> Dict[str, object]:
    """Run the rehearsal's six steps in ``workdir`` from the stage YAMLs in
    ``config_dir`` (default ``configs/rehearsal``) on ``num_faces``
    synthetic faces; ``device`` goes to every CLI that runs a model.
    Returns the paths made, each stage's seconds and the comparison's
    summary; with ``REHEARSAL_SETUP_ONLY=1`` it stops after the configs."""
    from facesr_torch.cli import compare_two_models, stage_panel, train
    from facesr_torch.cli.make_synthetic_faces import write_faces
    from facesr_torch.data import prepare_data
    from facesr_torch.device import resolve_device

    work = Path(workdir).resolve()  # absolute: the configs embed it
    work.mkdir(parents=True, exist_ok=True)
    configs = write_configs(work, Path(config_dir) if config_dir else REPO / "configs/rehearsal")
    if os.environ.get("REHEARSAL_SETUP_ONLY", "0") == "1":
        print(f"setup-only: configs generated in {work / 'configs'}")
        return {"configs": configs}
    resolve_device(device)  # no card and no device: raise before any work
    dev = ["--device", device] if device else []
    seconds: Dict[str, float] = {}

    def timed(name: str, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        return out

    print("== [1/6] synthetic faces ==", flush=True)
    timed("faces", lambda: write_faces(str(work / "raw"), num_faces, FACE_SIZE, 0))
    print(f"wrote {num_faces} images ({FACE_SIZE}x{FACE_SIZE}) to {work / 'raw'}")

    print(f"== [2/6] prepare (hr {HR_SIZE} / lr {LR_SIZE}, bicubic, hdf5) ==", flush=True)
    processed = work / "processed"
    timed("prepare", lambda: prepare_data.main(
        ["--input", str(work / "raw"), "--output", str(processed), "--hr-size", str(HR_SIZE),
         "--lr-size", str(LR_SIZE), "--hdf5", "--train-ratio", "0.84", "--val-ratio", "0.08"]))

    ckpts = {}
    for i, (name, title) in enumerate(zip(STAGES, ("PSNR", "+SSIM, chained from stage-1 best",
                                                   "GAN, chained from stage-2 best"))):
        print(f"== [{i + 3}/6] stage {i + 1}: {title} ==", flush=True)
        code = timed(name, lambda n=name: train.main(
            ["--config", str(configs[n]), "--no-wandb", "--yes"] + dev))
        _check(code, f"stage {i + 1} ({configs[name]})")
        ckpts[name] = work / f"ckpt_s{i + 1}" / "best_model.fckpt"
        if not ckpts[name].exists():
            raise RuntimeError(f"stage {i + 1} wrote no {ckpts[name]}")

    print("== [6/6] stage overview + comparison ==", flush=True)
    print("stage overview plot: not drawn (it needs matplotlib, ROADMAP A.8.4); going on")
    best_all = work / "best_all"
    best_all.mkdir(exist_ok=True)
    for name in STAGES:
        shutil.copy(ckpts[name], best_all / f"{name}.fckpt")
    test_hr = processed / "test" / "HR"
    comparison = timed("compare", lambda: compare_two_models.run(
        ["--checkpoint-dir", str(best_all), "--test-dir", str(test_hr),
         "--output", str(work / "comparison"), "--num-images", "32", "--batch-size", "8",
         "--save-every", "8"] + dev))
    panel = timed("panel", lambda: stage_panel.main(
        ["--checkpoints", str(ckpts["stage2_ssim"]), str(ckpts["stage3_gan"]),
         "--labels", "stage2_ssim", "stage3_gan", "--test-dir", str(test_hr),
         "--output", str(work / "panel"), "--num-images", "4"] + dev))
    print(f"Dress rehearsal complete: {work}")
    return {"configs": configs, "checkpoints": ckpts, "best_all": best_all,
            "test_hr": test_hr, "comparison": comparison, "panel": panel,
            "seconds": seconds}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Stage 1 -> 2 -> 3 dress rehearsal (PyTorch port)")
    p.add_argument("workdir", nargs="?", default=DEFAULT_WORK)
    p.add_argument("--device", default=None,
                   help="torch device of training and evaluation (CUDA when omitted)")
    args = p.parse_args(argv)
    rehearse(args.workdir, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
