"""Export a model as a self-contained serving artifact, then predict with
it, on the port: the counterpart of ``examples/export_serving_artifact.py``.

Two subcommands:

  export:  a registry entry (``--config``) or a class and its arguments
           (``--model``/``--model-args``), with a state dict saved by the
           port's trainer (``--checkpoint``; seeded random weights
           without one), -> one artifact (``serve.export_window_forward``)
           with the weights inside. ``--group 50`` exports the
           block-diagonal cross-batch attention, so that every dispatch
           reproduces the reference's batch-50 test composition
           (exp180d…py:62-65). ``--int8`` exports the W8A8 serving mode
           (the int8 GEMM's operator in the program) after its drift
           gate, verified on the whole protocol span of
           ``--calibrate-hcqt``; above the gate it refuses unless
           ``--int8-hybrid`` finds a passing policy or ``--allow-drift``.
  predict: artifact + HCQT .npy -> framewise prediction .npy, with no
           model code or checkpoint.

Examples:
    python -m multipitch_architectures_tpu_torch.experiments.export export \\
        --config exp180e_musicnet_unet_insanelylarge_doubleselfattn \\
        --checkpoint runs/models/exp180e.../best.pt --group 50 \\
        --batch-size 250 --out saunet_xl.mptpu
    python -m multipitch_architectures_tpu_torch.experiments.export predict \\
        --artifact saunet_xl.mptpu --hcqt file_hcqt.npy --batch-size 250 \\
        --out pred.npy

Both run on the card unless ``--device cpu`` is given; without a card
and without it they stop with an error.
"""

import argparse
import json
import os
import sys

import numpy as np

REFERENCE_BATCH = 50          # the reference's test batch (exp180d…py:62)


def _model(args):
    """The model in eval mode on the CPU, its weights loaded, and its
    name."""
    import torch

    from .. import models
    from .configs import load_checkpoint, load_experiment

    if bool(args.config) == bool(args.model):
        sys.exit("give --config or --model (with --model-args), not both")
    overrides = ({"attn_mode": f"cross_batch:{args.group}"} if args.group
                 else {})
    if args.config:
        model = load_experiment(args.config).build_model(**overrides)
        name = args.config
    else:
        kwargs = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in json.loads(args.model_args or "{}").items()}
        model = getattr(models, args.model)(**kwargs, **overrides)
        name = args.model
    if args.checkpoint:
        load_checkpoint(model, args.checkpoint)
    else:
        models.init_parameters_flax(model, torch.Generator().manual_seed(0))
    return model.eval(), name


def _batch_mode(model, batch_size):
    from ..ops.attention import TorchMultiheadAttention

    modes = {m.mode for m in model.modules()
             if isinstance(m, TorchMultiheadAttention)}
    if not modes or modes == {"tokens"}:
        return "independent"
    if len(modes) > 1:
        sys.exit(f"the model mixes attention modes {sorted(modes)}")
    mode = modes.pop()
    if mode == "cross_batch":
        return "cross_batch"
    g = int(mode.split(":", 1)[1])
    if batch_size % g:
        sys.exit(f"--batch-size {batch_size} must be a multiple of the "
                 f"attention group {g}")
    return f"grouped:{g}"


def _int8_windows(args, device, group):
    """(calibration, verification) window batches of 50: the leading
    protocol batches of ``--calibrate-hcqt`` (centres clipped into a
    short recording) and its whole protocol span; or, without it, one
    batch of random noise for both."""
    import torch

    from ..data.windows import gather_windows
    from ..eval.inference import _pad_inputs
    from ..eval.quant import _gate_verify_windows

    if not args.calibrate_hcqt:
        print("WARNING: --int8 without --calibrate-hcqt calibrates "
              "activation scales on random noise; real recordings whose "
              "activations exceed that range will clip. Pass "
              "--calibrate-hcqt with a representative HCQT .npy.",
              file=sys.stderr)
        rng = np.random.RandomState(0)
        cal = [torch.log1p(10.0 * torch.from_numpy(
            rng.rand(REFERENCE_BATCH, 6, 75, 216).astype(np.float32))).to(
                device)]
        return cal, cal
    hcqt = _load_hcqt(args.calibrate_hcqt)
    x = torch.log1p(10.0 * torch.from_numpy(hcqt).to(device))
    half, t = 37, x.shape[1]
    xp = _pad_inputs(x, 75)
    cal = [gather_windows(xp, np.minimum(
        half + REFERENCE_BATCH * b + np.arange(REFERENCE_BATCH),
        half + t - 1), 75) for b in range(min(4, -(-t // REFERENCE_BATCH)))]
    # the gate reads the whole protocol span: spread windows under-read
    # the true drift (ROADMAP, findings: 8.9e-4 read where it was 1.83e-3)
    verify = _gate_verify_windows(xp, t, REFERENCE_BATCH, 75, group)
    return cal, verify


def _int8_model(model, args, device, group):
    """The quantized copy that passes the drift gate, or a stop."""
    from ..eval import (auto_hybrid_int8, calibrate_activation_scales,
                        int8_drift_report, quantize_convs)

    cal, verify = _int8_windows(args, device, group)
    scales = calibrate_activation_scales(
        model, cal, percentile=args.calibrate_percentile,
        margin=args.calibrate_margin, per_channel=args.calibrate_per_channel)
    report = int8_drift_report(model, verify, activation_scales=scales,
                               gate=args.drift_gate)
    print(f"int8 drift on verification windows: worst measure "
          f"{report['worst']:.2e} (gate {report['gate']:.0e}), "
          f"pred max {report['pred_max']:.2e} "
          f"mean {report['pred_mean']:.2e}"
          + (f", skipped degenerate: {report['skipped']}"
             if report["skipped"] else ""))
    for k in sorted(report["measures"], key=report["measures"].get,
                    reverse=True)[:5]:
        print(f"  {k:28s} {report['measures'][k]:.2e}")
    exclude = ()
    if not report["passed"] and args.int8_hybrid:
        print("gate failed; searching hybrid int8/f32 policy ...")
        policy, report = auto_hybrid_int8(
            model, cal, gate=args.drift_gate,
            per_channel=args.calibrate_per_channel, verbose=True,
            verify_windows=verify, activation_scales=scales)
        scales, exclude = policy["activation_scales"], policy["exclude"]
        print(f"hybrid policy: {len(exclude)} conv(s) kept f32 "
              f"({', '.join(exclude)}); worst drift {report['worst']:.2e}")
    if not report["passed"]:
        msg = (f"int8 export REFUSED: worst measure drift "
               f"{report['worst']:.2e} exceeds the {report['gate']:.0e} "
               f"gate. Calibrate on representative data (--calibrate-hcqt),"
               f" pass --int8-hybrid to auto-demote drifting convs to f32, "
               f"raise --calibrate-margin, or pass --allow-drift to export "
               f"anyway.")
        if not args.allow_drift:
            sys.exit(msg)
        print("WARNING: " + msg.replace("REFUSED", "exceeds gate"),
              file=sys.stderr)
    return quantize_convs(model, activation_scales=scales, exclude=exclude)


def cmd_export(args):
    from .. import resolve_device
    from ..serve import export_window_forward

    device = resolve_device(args.device)
    model, name = _model(args)
    model.to(device)
    batch_mode = _batch_mode(model, args.batch_size)
    if args.int8:
        group = (int(batch_mode.split(":")[1])
                 if batch_mode.startswith("grouped:") else None)
        model = _int8_model(model, args, device, group)
    blob = export_window_forward(
        model, batch_size=args.batch_size, batch_mode=batch_mode,
        devices=tuple(args.devices.split(",")) if args.devices else None,
        meta=dict(model=name, checkpoint=os.path.basename(args.checkpoint)
                  if args.checkpoint else None))
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"wrote {args.out} ({len(blob) / 1e6:.1f} MB, "
          f"batch {args.batch_size}, {batch_mode})")


def _load_hcqt(path):
    """An HCQT .npy as (6, T, 216) float32: the reference's (216, T, 6)
    layout is transposed."""
    hcqt = np.load(path)
    if hcqt.shape[0] != 6:
        hcqt = hcqt.transpose(2, 1, 0)
    return np.ascontiguousarray(hcqt, dtype=np.float32)


def cmd_predict(args):
    from .. import resolve_device
    from ..serve import load_window_forward, predict_framewise_exported

    device = resolve_device(args.device)
    with open(args.artifact, "rb") as f:
        fn = load_window_forward(f.read(), device=device)
    pred = predict_framewise_exported(fn, _load_hcqt(args.hcqt),
                                      batch_size=args.batch_size
                                      or fn.meta.get("batch_size",
                                                     REFERENCE_BATCH),
                                      compression=args.compression)
    np.save(args.out, pred.cpu().numpy())
    print(f"wrote {args.out} {tuple(pred.shape)}")


def parser():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("export")
    e.add_argument("--config", help="experiment name from the registry")
    e.add_argument("--model", help="model class, e.g. "
                                   "simple_u_net_doubleselfattn")
    e.add_argument("--model-args", help="the class's arguments as JSON")
    e.add_argument("--checkpoint",
                   help="state dict (or the trainer's best.pt)")
    e.add_argument("--group", type=int, default=0,
                   help="export cross_batch:<group> attention")
    e.add_argument("--int8", action="store_true",
                   help="export the calibrated W8A8 int8 serving variant")
    e.add_argument("--calibrate-hcqt",
                   help="HCQT .npy for int8 activation calibration")
    e.add_argument("--calibrate-percentile", type=float, default=None,
                   help="calibrate on this percentile of |x| instead of "
                        "the max (e.g. 99.9)")
    e.add_argument("--calibrate-margin", type=float, default=1.0,
                   help="headroom multiplier on calibrated scales")
    e.add_argument("--calibrate-per-channel", action="store_true",
                   help="per-input-channel activation scales")
    e.add_argument("--drift-gate", type=float, default=1e-3,
                   help="max allowed int8 measure drift on the "
                        "verification windows")
    e.add_argument("--int8-hybrid", action="store_true",
                   help="if the drift gate fails, demote the most damaging"
                        " convs to float32 until it passes")
    e.add_argument("--allow-drift", action="store_true",
                   help="export even if the drift gate fails (warns)")
    e.add_argument("--batch-size", type=int, default=REFERENCE_BATCH)
    e.add_argument("--device", default=None,
                   help="device to trace on (default: the card)")
    e.add_argument("--devices", default="",
                   help="comma-separated device types the artifact may be "
                        "loaded on (default: the tracing device's)")
    e.add_argument("--out", required=True)
    e.set_defaults(fn=cmd_export)

    r = sub.add_parser("predict")
    r.add_argument("--artifact", required=True)
    r.add_argument("--hcqt", required=True)
    r.add_argument("--batch-size", type=int, default=None,
                   help="dispatch size (default: the artifact's)")
    r.add_argument("--compression", type=float, default=10.0)
    r.add_argument("--device", default=None,
                   help="device to serve on (default: the card)")
    r.add_argument("--out", required=True)
    r.set_defaults(fn=cmd_predict)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
