"""Work counts from shapes against counts taken by hand and by hooking
every convolution of the reference network."""
import json

import pytest
import torch
import torch.nn.functional as F

from gpubench.reference import net as ref_net
from gpubench.work import (HBM_BYTES_PER_S, PEAK_FLOPS, chain_levels, chain_work,
                           forward_flops, roofline_s)

CFG = json.load(open("gpubench/configs/improved_unet48_f32.json"))


def _hooked_macs(cfg, batch, hw):
    """Multiply-adds of every conv the reference runs, counted as it runs."""
    total = []

    def conv(x, w, b, p):
        y = F.conv2d(x, w, b, padding=p)
        total.append(y.numel() * w.shape[1] * w.shape[2] * w.shape[3])
        return y

    sd = ref_net.make_weights(cfg, 0, "cpu")
    with torch.no_grad():
        ref_net.forward(sd, torch.rand(batch, cfg["n_channel"], hw, hw), cfg, conv)
    return sum(total)


@pytest.mark.parametrize("nf,hw,batch", [(8, 32, 2), (4, 48, 1)])
def test_forward_flops_count_every_conv_the_network_runs(nf, hw, batch):
    cfg = dict(CFG, n_feature=nf)
    assert forward_flops(cfg, batch, hw) == 2 * _hooked_macs(cfg, batch, hw)


def test_chain_work_by_hand():
    # lead 3x3 conv 2->48, four growth convs 48+32i->32, 1x1 LFF 176->48, 3x3 48->48
    macs = 9 * 2 * 48 + 9 * 32 * (48 + 80 + 112 + 144) + 176 * 48 + 9 * 48 * 48
    flops, nbytes = chain_work(352, 2, 48, True, 4, 8)
    assert flops == 2 * 8 * 352 * 352 * macs
    params = macs + 48 + 4 * 32 + 48
    assert nbytes == (8 * 352 * 352 * (2 + 2 * 48) + params) * 4


def test_chain_covers_the_level_convs_of_the_forward():
    """The chain's nine calls compute all but the noise estimator, the
    ResBlocks' second conv, the up convs and the final conv."""
    hw = 352
    rest = [s[0] for s in ref_net.layer_specs(CFG) if len(s) == 5 and (
        s[0].startswith("noise") or s[0] == "final" or s[0].endswith("conv_ps")
        or s[0].endswith(".block.3"))]
    chain = sum(chain_work(h, c, n, lead, 4, 1)[0] for h, c, n, lead in chain_levels(CFG, hw))
    full = forward_flops(CFG, 1, hw)
    assert 0.7 < chain / full < 0.85
    assert len(rest) == 2 + 9 + 4 + 1
    # the full-size forward: 170.585 GFLOP a 352^2 tile
    assert full == pytest.approx(1.70585327616e11, rel=1e-12)


def test_roofline_takes_the_longer_bound():
    assert roofline_s(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert roofline_s(0, HBM_BYTES_PER_S, "tf32x3") == pytest.approx(1.0)
    assert PEAK_FLOPS["tf32x3"] == PEAK_FLOPS["tf32"] / 3
