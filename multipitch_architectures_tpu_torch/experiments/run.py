"""Run one of the reference's 111 experiments by name, on the port.

Examples:
    # list experiments
    python -m multipitch_architectures_tpu_torch.experiments.run --list
    # smoke-run the SAUnet:L experiment on synthetic data on the CPU
    python -m multipitch_architectures_tpu_torch.experiments.run \\
        --config exp180d_musicnet_unet_extremelylarge_doubleselfattn \\
        --smoke --cpu
    # full run on precomputed features, on the card
    python -m multipitch_architectures_tpu_torch.experiments.run \\
        --config exp180d_musicnet_unet_extremelylarge_doubleselfattn \\
        --data-dir /data/MusicNet/hcqt --annot-dir /data/MusicNet/pitch \\
        --out-dir runs/

Runs on the card unless ``--cpu`` is given; without a card and without
``--cpu`` it stops with an error. Training from audio (``--audio-dir``)
is not ported yet.
"""

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", help="experiment name from the registry")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--data-dir")
    ap.add_argument("--annot-dir")
    ap.add_argument("--out-dir", default="runs")
    ap.add_argument("--smoke", action="store_true",
                    help="synthetic data + 1 epoch + shrunken model")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--fix-val-split", action="store_true",
                    help="repair the reference's merged val prefixes")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--resume", action="store_true",
                    help="restore the experiment checkpoint and continue"
                         " training from the next epoch")
    args = ap.parse_args(argv)

    from . import (NpyCorpus, SyntheticCorpus, available_experiments,
                   load_experiment, run_experiment, shrink_for_smoke)

    if args.list:
        for name in available_experiments():
            print(name)
        return 0
    if not args.config:
        ap.error("--config is required (or --list)")

    cfg = load_experiment(args.config, fix_val_split=args.fix_val_split)
    if args.smoke:
        cfg = shrink_for_smoke(cfg)
        corpus = SyntheticCorpus(cfg, frames=300)
        epochs = args.epochs or 1
    else:
        if not (args.data_dir and args.annot_dir):
            ap.error("--data-dir and --annot-dir are required without "
                     "--smoke")
        corpus = NpyCorpus(args.data_dir, args.annot_dir)
        epochs = args.epochs
    results = run_experiment(cfg, corpus, args.out_dir,
                             max_epochs_override=epochs, resume=args.resume,
                             device="cpu" if args.cpu else None)
    if results.get("subsets"):
        fw = results["subsets"][0]["framewise_mean"]
        print(f"Framewise f_measure: {fw.get('f_measure')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
