"""The frozen counts equal FlopCounterMode over the benchmark's own
reference."""

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.common import ROOT, load_json
from portbench.counts import cqt, saunet
from portbench.reference import frontend
from portbench.reference.saunet import SAUnet

SMALL = {"a_lrelu": 0.3, "embed_dim": 32, "mlp_dim": 64, "n_bins_in": 216,
         "n_bins_out": 72, "n_chan_input": 6, "n_chan_layers": [8, 6, 5, 4],
         "num_heads": 8, "p_dropout": 0.2, "pos_encoding": "sinusoidal",
         "scalefac": 16}


def counted(args, batch, train):
    torch.manual_seed(0)
    m = SAUnet(**{**args, "n_chan_layers": tuple(args["n_chan_layers"])})
    x = torch.rand(batch, 6, 75, 216)
    with FlopCounterMode(display=False) as fc:
        y = m(x)
        if train:
            y.sum().backward()
    return fc.get_total_flops()


def test_saunet_counts_at_a_small_size():
    torch.set_num_threads(2)
    assert saunet.forward_flops(SMALL, 3) == counted(SMALL, 3, False)
    assert saunet.train_step_flops(SMALL, 3) == counted(SMALL, 3, True)
    # a batch of 10 in groups of 5 counts as two batches of 5
    assert saunet.forward_flops(SMALL, 10, 5) == \
        2 * saunet.forward_flops(SMALL, 5)


def test_saunet_counts_at_the_configurations_widths():
    for name, batch in (("exp180e-f32", 50), ("exp180d-f32", 25)):
        args = load_json(f"{ROOT}/portbench/configs/{name}.json")["model"][
            "args"]
        with torch.device("meta"):
            m = SAUnet(**{**args, "n_chan_layers":
                          tuple(args["n_chan_layers"])})
            x = torch.zeros(batch, 6, 75, 216)
            with FlopCounterMode(display=False) as fc:
                m(x).sum().backward()
        assert saunet.train_step_flops(args, batch) == fc.get_total_flops()


def test_k1_product_count_equals_the_reference_frontends_products():
    fe = load_json(f"{ROOT}/portbench/configs/exp180e-f32.json")["frontend"]
    y = np.random.default_rng(0).standard_normal(22050).astype(np.float32)
    with FlopCounterMode(display=False) as fc:
        frontend.hcqt(y, fe, "cpu")
    mm = sum(v for k, v in fc.get_flop_counts()["Global"].items()
             if "mm" in str(k))
    assert mm == cqt.product_flops(fe, len(y))
    assert len(cqt.octaves(fe, len(y))) == 21
