"""Predict pitch salience with a pretrained checkpoint, on the port: the
counterpart of ``examples/predict_pretrained.py`` (the reference's
02_predict_with_pretrained_model.ipynb).

Takes a reference ``state_dict`` ``.pt`` (the port's modules carry the
reference's key names, so it loads as it is, ``strict=True``) or a
checkpoint of the port's trainer, the reference class name and its
arguments, and a precomputed HCQT ``.npy`` (216, T, 6) or an audio file
(``.wav`` or raw ``.npy`` at 22.05 kHz, its HCQT computed on the card
through the CQT kernel), and writes the framewise prediction (T, 72)
``.npy``; the polyphony classes also write their polyphony logits to
``<out>_polyphony.npy``. ``--int8`` serves in the int8 (W8A8) mode,
calibrated on the recording (``eval.predict_framewise_int8``).

Example (the notebook's PUnet checkpoint):
    python -m multipitch_architectures_tpu_torch.experiments.predict \\
        --checkpoint RETRAIN4_exp195f_...pt \\
        --model simple_u_net_polyphony_classif_softmax \\
        --model-args '{"n_chan_layers": [128,180,150,100], "n_bins_out": 72,
                       "scalefac": 2, "num_polyphony_steps": 24}' \\
        --audio some_file.wav --out pred.npy

Runs on the card unless ``--device cpu`` is given; without a card and
without it, it stops with an error.
"""

import argparse
import json
import sys
import time

import numpy as np

FS = 22050
# the example's frontend: 50 frames/s, 36 bins per octave, 6 octaves
HCQT_KW = dict(fs=FS, fs_hcqt_target=50, bins_per_octave=36, num_octaves=6)


def predict_pretrained(checkpoint: str, model: str, model_args=None,
                       hcqt: str = None, audio: str = None,
                       exact_frontend: bool = False, batch_size: int = 50,
                       int8: bool = False, device=None):
    """The framewise prediction (T, bins) of ``model`` (a reference class
    name; ``model_args`` its arguments) with the weights of
    ``checkpoint``, on the HCQT ``.npy`` at ``hcqt`` or the audio file at
    ``audio``, in the windowed protocol at ``batch_size``; float32 numpy.
    A polyphony class returns ``(pred, polyphony logits)``."""
    import torch

    from .. import resolve_device
    from ..dsp import compute_efficient_hcqt
    from ..eval import predict_framewise, predict_framewise_int8
    from ..io import load_audio
    from .configs import build_model, load_checkpoint

    if (hcqt is None) == (audio is None):
        raise ValueError("give an HCQT or an audio file, not both")
    dev = resolve_device(device)
    net = load_checkpoint(build_model(model, dict(model_args or {})),
                          checkpoint).eval().to(dev)
    if hcqt is not None:
        f = np.load(hcqt)
    else:
        f, _, _ = compute_efficient_hcqt(load_audio(audio, FS),
                                         exact=exact_frontend, device=dev,
                                         **HCQT_KW)
    # the reference's (216, T, 6) -> the model's (6, T, 216)
    x = torch.from_numpy(np.ascontiguousarray(
        np.transpose(f, (2, 1, 0)), np.float32)).to(dev)
    run = predict_framewise_int8 if int8 else predict_framewise
    with torch.no_grad():
        out = run(net, x, batch_size=batch_size,
                  return_aux="polyphony" in model)
    if isinstance(out, tuple):
        return tuple(o.cpu().numpy() for o in out)
    return out.cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--checkpoint", required=True,
                    help="reference state_dict .pt, or the port trainer's "
                         "checkpoint")
    ap.add_argument("--model", required=True,
                    help="reference model class name")
    ap.add_argument("--model-args", default="{}", help="JSON kwargs")
    ap.add_argument("--hcqt", help="precomputed HCQT .npy (216, T, 6)")
    ap.add_argument("--audio", help="audio .npy/.wav (22.05 kHz)")
    ap.add_argument("--exact-frontend", action="store_true",
                    help="with --audio: exact per-octave full-rate CQT "
                         "(no multirate approximation; slower)")
    ap.add_argument("--out", default="prediction.npy")
    ap.add_argument("--batch-size", type=int, default=50)
    ap.add_argument("--int8", action="store_true",
                    help="int8 (W8A8) serving mode, calibrated on the "
                         "recording (eval.predict_framewise_int8)")
    ap.add_argument("--device", default=None,
                    help="device to predict on (default: the card)")
    args = ap.parse_args(argv)
    if bool(args.hcqt) == bool(args.audio):
        ap.error("give --hcqt or --audio")

    from .. import set_f32_parity

    set_f32_parity()          # float32 as the JAX package computes it
    t0 = time.perf_counter()
    pred = predict_pretrained(
        args.checkpoint, args.model, json.loads(args.model_args),
        hcqt=args.hcqt, audio=args.audio,
        exact_frontend=args.exact_frontend, batch_size=args.batch_size,
        int8=args.int8, device=args.device)
    if isinstance(pred, tuple):
        pred, n_pred = pred
        poly_out = args.out.replace(".npy", "_polyphony.npy")
        np.save(poly_out, n_pred)
        print(f"polyphony {n_pred.shape} -> {poly_out}")
    np.save(args.out, pred)
    print(f"prediction {pred.shape} -> {args.out} in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
