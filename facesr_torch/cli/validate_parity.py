"""Parity-acceptance harness of the port: reference ``.pth`` artifacts ->
a PASS/FAIL table, with the flags of the JAX package's
`scripts/validate_parity.py`:

    python -m facesr_torch.cli.validate_parity --artifacts <pth dir> \\
        --test-dir <HR dir> --output outputs/parity [--int8] [--device cpu]

Artifacts are classified by their state-dict keys, not their names:
FaceEnhanceNet, TransferSRModel and RRDBNet state dicts become model rows
(each converted once to a ``.fckpt`` that both packages read); a
torchvision AlexNet together with the lpips package's linear heads gives
the LPIPS column; an InceptionV3 (pytorch-fid or torchvision, BatchNorm
folded) gives FID; a torchvision VGG19 is converted for the perceptual
loss and reported. Pre-converted ``.fckpt`` models pass through. A file
that does not read or convert is skipped with its reason.

Each model and the OpenCV baselines (the port's copies of cv2's
``INTER_LINEAR``, ``INTER_CUBIC``, ``INTER_LANCZOS4``) are scored on the
HR PNGs of ``--test-dir`` (LR synthesised on the device, the trainer's
bicubic) with skimage-compatible PSNR/SSIM at data_range 255, LPIPS and
FID when their weights came with the artifacts, through the batched
`Predictor` in f32. ``--int8`` adds each model row's calibrated
int8_full agreement with its own f32 forward and its PSNR/SSIM deltas
(`scripts/validate_parity.py:226-260`). Targets default to
the published table (baselines by name, models matched on the checkpoint
stem); ``--targets`` overrides them; ``--emit-targets`` writes the
measured values as a targets file instead of checking. The exit code is
1 when a row fails. It runs on one CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

__all__ = ["DEFAULT_TARGETS", "DEFAULT_TOLERANCES", "classify_state_dict",
           "discover_and_convert", "evaluate_methods", "match_target", "build_report",
           "print_table", "parse_args", "run", "main"]

# Published reference numbers (BASELINE.md <- reference README.md:81-86).
DEFAULT_TARGETS = {
    "Bilinear": {"psnr": 26.43, "ssim": 0.7843, "lpips": 0.3407},
    "Bicubic": {"psnr": 26.31, "ssim": 0.7861, "lpips": 0.3716},
    "Lanczos4": {"psnr": 26.10, "ssim": 0.7754, "lpips": 0.3883},
    "transfer": {"psnr": 26.97, "ssim": 0.7940, "lpips": 0.1081},
    "custom": {"psnr": 26.39, "ssim": 0.7734, "lpips": 0.0695},
}
DEFAULT_TOLERANCES = {"psnr": 0.1, "ssim": 0.001, "lpips": 0.002}
BASELINES = {"Bilinear": "linear", "Bicubic": "cubic", "Lanczos4": "lanczos4"}


def classify_state_dict(sd) -> Optional[str]:
    """A reference-format state dict's kind by its key fingerprint (the
    models by `models.load.sniff_model_type`)."""
    from facesr_torch.models.load import sniff_model_type

    model = sniff_model_type(sd)
    if model is not None:
        return {"esrgan": "rrdbnet"}.get(model, model)
    keys = sd.keys()
    if "Mixed_5b.branch1x1.conv.weight" in keys:
        return "inception"
    if "lin0.model.1.weight" in keys or "lins.0.model.1.weight" in keys:
        return "lpips_lins"
    # vgg19.features has convs up to index 34, alexnet stops at 10; check
    # the deeper net first (their shallow keys overlap)
    prefix = "features." if any(k.startswith("features.") for k in keys) else ""
    if f"{prefix}19.weight" in keys or f"{prefix}34.weight" in keys:
        return "vgg19"
    if f"{prefix}10.weight" in keys and f"{prefix}12.weight" not in keys:
        return "alexnet"
    return None


def discover_and_convert(artifacts_dir: Path, work_dir: Path) -> dict:
    """Scan the artifacts, convert each recognised ``.pth``; returns
    ``{"models": {stem: .fckpt}, "lpips", "inception", "vgg19": path or
    None, "skipped": [names]}``."""
    from facesr_torch.ckpt.weights import read_state_dict
    from facesr_torch.cli.convert import convert_pth

    work_dir.mkdir(parents=True, exist_ok=True)
    inv = {"models": {}, "lpips": None, "inception": None, "vgg19": None, "skipped": []}
    alexnet = lins = None
    for pth in sorted(artifacts_dir.glob("*.pth")) + sorted(artifacts_dir.glob("*.pt")):
        try:
            sd = read_state_dict(str(pth))
            kind = classify_state_dict(sd)
        except Exception as e:  # noqa: BLE001 — an unreadable file is skipped
            print(f"  SKIP {pth.name}: unreadable ({e})")
            inv["skipped"].append(pth.name)
            continue
        if kind is None:
            print(f"  SKIP {pth.name}: unrecognized state-dict layout")
            inv["skipped"].append(pth.name)
            continue
        if kind == "alexnet":
            alexnet = pth
            continue
        if kind == "lpips_lins":
            lins = pth
            continue
        out = work_dir / f"{pth.stem}.fckpt"
        try:
            convert_pth(str(pth), str(out), kind=kind)
            if kind in ("custom", "transfer", "rrdbnet"):
                inv["models"][pth.stem] = out
            else:
                inv[kind] = out
        except Exception as e:  # noqa: BLE001 — a malformed artifact is skipped
            print(f"  SKIP {pth.name}: conversion failed ({e})")
            inv["skipped"].append(pth.name)
            continue
        print(f"  converted {pth.name} ({kind}) -> {out}")
    if alexnet is not None and lins is not None:
        out = work_dir / "lpips_alex.fckpt"
        convert_pth(str(alexnet), str(out), kind="lpips", extra_pth=str(lins))
        inv["lpips"] = out
    elif alexnet is not None or lins is not None:
        have = "alexnet backbone" if alexnet is not None else "lpips lin heads"
        print(f"  WARNING: found only the {have}: LPIPS needs both the torchvision alexnet "
              "and the lpips package's lin heads; the LPIPS column will be unavailable")
    for fck in sorted(artifacts_dir.glob("*.fckpt")):
        inv["models"].setdefault(fck.stem, fck)
    return inv


def evaluate_methods(inv: dict, test_dir: Path, num_images: int, scale: int, int8: bool,
                     calibrate: int, max_batch: Optional[int], device=None):
    """Measured metrics per method: (rows, int8_rows, fid_note), rows =
    {name: {psnr, ssim[, lpips][, fid]}}, int8_rows = {name:
    {agreement_psnr, delta_psnr, ...}} (int8_full against the model's own
    f32 forward)."""
    import torch

    from facesr_torch.data.cv_compat import resize
    from facesr_torch.data.dataset import _list_images
    from facesr_torch.data.codecs import ImageDecodeError, UnsupportedImage, imread
    from facesr_torch.device import resolve_device
    from facesr_torch.evaluation.batched import (make_predictor, sr_batched,
                                                 synthesize_lr_batched, to_uint8)
    from facesr_torch.evaluation.metrics import LPIPS
    from facesr_torch.evaluation.skimage_compat import (peak_signal_noise_ratio,
                                                        structural_similarity)
    from facesr_torch.models.load import load_any_model

    dev = resolve_device(device)
    files = (_list_images(test_dir) if test_dir.is_dir() else [])[:num_images]
    if not files:
        raise SystemExit(f"No test images in {test_dir}")
    print(f"\nEvaluating on {len(files)} images from {test_dir}")
    hrs = []
    for f in files:
        try:
            h = imread(f)
        except UnsupportedImage:
            raise
        except ImageDecodeError as e:
            print(f"  skipping unreadable image {f.name} ({e})")
            continue
        oy, ox = (h.shape[0] % scale) // 2, (h.shape[1] % scale) // 2
        hrs.append(h[oy:oy + h.shape[0] // scale * scale, ox:ox + h.shape[1] // scale * scale])
    if not hrs:
        raise SystemExit(f"No readable test images in {test_dir}")
    lrs = synthesize_lr_batched(hrs, scale, device=dev)
    lrs_u8 = [to_uint8(lr) for lr in lrs]
    lpips_fn = LPIPS(weights_path=str(inv["lpips"]) if inv["lpips"] else None, verbose=True)

    def metrics_of(srs) -> Dict[str, float]:
        ps, ss, lp = [], [], []
        for sr, hr in zip(srs, hrs):
            ps.append(peak_signal_noise_ratio(hr, sr, data_range=255))
            ss.append(structural_similarity(hr, sr, data_range=255, channel_axis=-1))
            if lpips_fn.available:
                a = torch.from_numpy(sr[None].astype(np.float32) / 255.0).to(dev)
                b = torch.from_numpy(hr[None].astype(np.float32) / 255.0).to(dev)
                lp.append(float(lpips_fn(a, b)))
        out = {"psnr": float(np.mean(ps)), "ssim": float(np.mean(ss))}
        if lp:
            out["lpips"] = float(np.mean(lp))
        return out

    rows, sr_sets = {}, {}
    for name, interp in BASELINES.items():
        srs = [resize(lr, (hr.shape[1], hr.shape[0]), interp) for lr, hr in zip(lrs_u8, hrs)]
        rows[name], sr_sets[name] = metrics_of(srs), srs
        print(f"  {name}: {rows[name]}")

    int8_rows = {}
    for stem, path in inv["models"].items():
        try:
            model = load_any_model(path, device=dev)
        except Exception as e:  # noqa: BLE001 — a pass-through file that is no SR model
            print(f"  SKIP {Path(path).name}: not a loadable SR model ({e})")
            inv["skipped"].append(Path(path).name)
            continue
        srs = sr_batched(None, lrs, predictor=make_predictor(model, max_batch=max_batch,
                                                             device=dev))
        rows[stem], sr_sets[stem] = metrics_of(srs), srs
        print(f"  {stem}: {rows[stem]}")
        if not int8:
            continue
        calib = np.stack([lr for lr in lrs[:max(calibrate, 1)] if lr.shape == lrs[0].shape])
        pred8 = make_predictor(model, max_batch=max_batch, dtype="int8_full", device=dev,
                               calibration=calib)
        srs8 = sr_batched(None, lrs, predictor=pred8)
        agree = float(np.mean([peak_signal_noise_ratio(a, b, data_range=255)
                               for a, b in zip(srs, srs8)]))
        m8 = metrics_of(srs8)
        int8_rows[stem] = {"agreement_psnr": agree,
                           "delta_psnr": m8["psnr"] - rows[stem]["psnr"],
                           "delta_ssim": m8["ssim"] - rows[stem]["ssim"],
                           **{f"int8_{k}": v for k, v in m8.items()}}
        print(f"  {stem} [int8_full calibrated]: agreement {agree:.2f} dB, dPSNR "
              f"{int8_rows[stem]['delta_psnr']:+.3f}")

    fid_note = None
    weights = None
    if inv["inception"]:
        from facesr_torch.models.inception import load_inception_weights

        try:
            weights = load_inception_weights(str(inv["inception"]))
        except Exception as e:  # noqa: BLE001 — a broken weight file is a note
            fid_note = f"FID backend weights unloadable: {e}"
    if weights is not None:
        from facesr_torch.evaluation.fid import fid_from_activations, inception_activations

        try:
            act_hr = inception_activations(hrs, weights, device=dev)
            for name, srs in sr_sets.items():
                rows[name]["fid"] = fid_from_activations(
                    act_hr, inception_activations(srs, weights, device=dev))
                print(f"  FID {name}: {rows[name]['fid']:.3f}")
        except Exception as e:  # noqa: BLE001 — tiny sets can be degenerate
            fid_note = f"FID computation failed: {e}"
            print(f"  {fid_note}")
    else:
        fid_note = fid_note or "FID backend unavailable (no InceptionV3 weights in the artifacts)"
    return rows, int8_rows, fid_note


def match_target(name: str, targets: dict) -> Optional[str]:
    """Exact row name first, then fuzzy stem matching for model rows."""
    if name in targets:
        return name
    low = name.lower()
    for key in targets:
        if key not in BASELINES and key.lower() in low:
            return key
    return None


def build_report(rows, targets, tols, int8_rows, int8_max_drop, model_names=()):
    """(report entries, any failure): one entry a (row, metric); a model
    row that matches no target fails (NO_TARGET)."""
    report, any_fail = [], False
    for name, measured in rows.items():
        tkey = match_target(name, targets)
        if tkey is None and name in model_names:
            print(f"  ERROR: model '{name}' matched no target row ({sorted(targets)}); use "
                  "--targets or --emit-targets")
            report.append({"row": name, "metric": "target-match", "measured": float("nan"),
                           "status": "NO_TARGET"})
            any_fail = True
        for metric in ("psnr", "ssim", "lpips", "fid"):
            if metric not in measured:
                continue
            entry = {"row": name, "metric": metric, "measured": measured[metric]}
            target = (targets.get(tkey) or {}).get(metric) if tkey else None
            if target is None or metric not in tols:
                entry["status"] = "INFO"
            else:
                delta = measured[metric] - target
                ok = abs(delta) <= tols[metric]
                entry.update(target=target, delta=delta, tolerance=tols[metric],
                             matched_target_row=tkey, status="PASS" if ok else "FAIL")
                any_fail |= not ok
            report.append(entry)
    for name, vals in int8_rows.items():
        ok = vals["delta_psnr"] >= -int8_max_drop
        report.append({"row": f"{name} [int8]", "metric": "delta_psnr",
                       "measured": vals["delta_psnr"], "target": -int8_max_drop,
                       "tolerance": int8_max_drop, "status": "PASS" if ok else "FAIL", **vals})
        any_fail |= not ok
    return report, any_fail


def print_table(report) -> None:
    print(f"\n{'Row':<28} {'Metric':<10} {'Measured':>10} {'Target':>10} {'Delta':>9}  Status")
    print("-" * 80)
    for e in report:
        tgt = f"{e['target']:.4f}" if e.get("target") is not None else "—"
        dlt = f"{e['delta']:+.4f}" if "delta" in e else "—"
        print(f"{e['row']:<28} {e['metric']:<10} {e['measured']:>10.4f} {tgt:>10} {dlt:>9}  "
              f"{e['status']}")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Validate metric parity of converted reference "
                                            "artifacts against the BASELINE tolerances "
                                            "(PyTorch port)")
    p.add_argument("--artifacts", required=True,
                   help="directory of reference .pth artifacts and/or .fckpt models")
    p.add_argument("--test-dir", required=True, help="directory of HR test PNGs")
    p.add_argument("--output", default="outputs/parity")
    p.add_argument("--num-images", type=int, default=4970)
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--targets", default=None,
                   help="JSON {row: {psnr, ssim, lpips[, fid]}} (or {'rows', 'tolerances'})")
    p.add_argument("--emit-targets", default=None, metavar="PATH",
                   help="write the measured values as a targets JSON, no pass/fail")
    p.add_argument("--int8", action="store_true",
                   help="also measure calibrated int8_full deltas (every model row)")
    p.add_argument("--calibrate", type=int, default=8,
                   help="eval LR images that calibrate int8_full")
    p.add_argument("--int8-max-drop", type=float, default=0.5,
                   help="largest int8 PSNR drop against f32 that passes (dB)")
    p.add_argument("--tolerance-psnr", type=float, default=None)
    p.add_argument("--tolerance-ssim", type=float, default=None)
    p.add_argument("--tolerance-lpips", type=float, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="forward batch (128 on CUDA, 8 on the CPU)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; CUDA when omitted (raises without a card)")
    return p.parse_args(argv)


def run(argv: Optional[List[str]] = None) -> dict:
    """Parse ``argv`` and validate; returns the report dict written to
    ``parity_report.json`` (or ``{"emitted": path}`` with
    ``--emit-targets``)."""
    args = parse_args(argv)
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    print(f"Scanning artifacts in {args.artifacts} ...")
    inv = discover_and_convert(Path(args.artifacts), out_dir / "converted")
    print(f"  models: {sorted(inv['models'])}")
    print(f"  lpips weights: {inv['lpips'] or 'absent'}")
    print(f"  inception weights: {inv['inception'] or 'absent'}")
    print("  vgg19 weights: " + str(inv["vgg19"] or "absent (perceptual-loss training parity "
                                     "untestable, metrics unaffected)"))
    if not inv["models"]:
        print("  WARNING: no SR model checkpoints found: validating baselines only")
    rows, int8_rows, fid_note = evaluate_methods(
        inv, Path(args.test_dir), args.num_images, args.scale, int8=args.int8,
        calibrate=args.calibrate, max_batch=args.batch_size, device=args.device)
    if args.emit_targets:
        Path(args.emit_targets).write_text(json.dumps(
            {"rows": rows, "tolerances": DEFAULT_TOLERANCES}, indent=2))
        print(f"\nWrote measured targets to {args.emit_targets} (no pass/fail in "
              "--emit-targets mode)")
        return {"emitted": args.emit_targets, "rows": rows, "skipped_artifacts": inv["skipped"]}
    targets, tols = dict(DEFAULT_TARGETS), dict(DEFAULT_TOLERANCES)
    if args.targets:
        loaded = json.loads(Path(args.targets).read_text())
        if "rows" in loaded:
            targets = loaded["rows"]
            tols.update(loaded.get("tolerances", {}))
        else:
            targets = loaded
    for metric in ("psnr", "ssim", "lpips"):
        override = getattr(args, f"tolerance_{metric}")
        if override is not None:
            tols[metric] = override
    report, any_fail = build_report(rows, targets, tols, int8_rows, args.int8_max_drop,
                                    model_names=set(inv["models"]))
    print_table(report)
    if fid_note:
        print(f"\nNote: {fid_note}")
    result = {"rows": rows, "int8": int8_rows, "report": report, "tolerances": tols,
              "skipped_artifacts": inv["skipped"], "verdict": "FAIL" if any_fail else "PASS"}
    (out_dir / "parity_report.json").write_text(json.dumps(result, indent=2))
    print(f"\nVerdict: {result['verdict']}  (report: {out_dir / 'parity_report.json'})")
    return result


def main(argv: Optional[List[str]] = None) -> int:
    result = run(argv)
    return 1 if result.get("verdict") == "FAIL" else 0


if __name__ == "__main__":
    sys.exit(main())
