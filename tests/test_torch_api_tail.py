"""The names the JAX package exports and the port added last:
``utils.StepTimer``, ``ckpt.load_state_dict`` and ``ckpt.import_pth``,
each against the JAX package's on the same input."""
import numpy as np
import pytest
import torch

from image_denoising_tpu import ckpt as jax_ckpt
from image_denoising_tpu import utils as jax_utils
from image_denoising_tpu_torch import ckpt, utils
from image_denoising_tpu_torch.adapters import OutputAdapter, build_memory_adapter
from image_denoising_tpu_torch.models import RESNET, ImprovedUNet, UNet


def test_names_are_exported():
    assert "StepTimer" in utils.__all__
    assert {"load_state_dict", "import_pth"} <= set(ckpt.__all__)


def test_step_timer_equals_jax(monkeypatch):
    """One ``time.perf_counter`` sequence for both timers: the same
    intervals, moving averages and rates, before and after the first step."""
    ticks = [10.0, 10.5, 10.75, 12.0, 12.01, 13.5]

    def run(cls):
        it = iter(ticks)
        monkeypatch.setattr("time.perf_counter", lambda: next(it))
        t = cls(ema=0.8)
        out = [(t.avg, t.last, str(t.steps_per_sec))]
        for _ in ticks[1:]:
            out.append((t.step(), t.avg, t.last, t.steps_per_sec))
        return out

    assert run(utils.StepTimer) == run(jax_utils.StepTimer)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_same_tree(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _seeded(module, seed):
    torch.manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():  # zero-initialised tails too
            p.uniform_(-0.5, 0.5)
    return module.state_dict()


def test_load_state_dict_equals_jax(tmp_path):
    """A DataParallel ``.pth`` (``module.`` on every key): the same names
    and numpy arrays."""
    sd = _seeded(OutputAdapter(1, 8), 3)
    path = str(tmp_path / "dp.pth")
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    got, want = ckpt.load_state_dict(path), jax_ckpt.load_state_dict(path)
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in want:
        assert isinstance(got[k], np.ndarray) and got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch,make,kwargs", [
    ("UNetImproved", lambda: ImprovedUNet(1, 1, 8), {}),
    ("UNetImproved", lambda: ImprovedUNet(1, 1, 8), {"depth": 4, "noise": True}),
    ("UNet", lambda: UNet(1, 1, 8), {}),
    ("RESNET", lambda: RESNET(1, 1, 8), {}),
    ("output_adapter", lambda: OutputAdapter(1, 8), {}),
])
def test_import_pth_equals_jax(tmp_path, arch, make, kwargs):
    """From a ``.pth`` path and from the state dict JAX's loader gives:
    JAX's tree, leaf for leaf."""
    path = str(tmp_path / "m.pth")
    torch.save(_seeded(make(), 4), path)
    want = jax_ckpt.import_pth(path, arch, **kwargs)
    _assert_same_tree(ckpt.import_pth(path, arch, **kwargs), want)
    _assert_same_tree(ckpt.import_pth(jax_ckpt.load_state_dict(path), arch, **kwargs), want)


@pytest.mark.parametrize("variant", ["memory_residual", "lowfreq_blend", "tone_curve",
                                     "hyper_gated", "hyper_gated_fft"])
def test_import_pth_memory_adapter_by_prefix(tmp_path, variant):
    """A wrapper checkpoint (``base.*`` and ``adapter.*``, saved through
    DataParallel): ``prefix="adapter"`` pulls out JAX's adapter tree and
    ``prefix="base"`` its base tree."""
    base = _seeded(ImprovedUNet(1, 1, 8), 5)
    adapter = _seeded(build_memory_adapter(variant, 1, 8), 6)
    sd = {**{f"module.base.{k}": v for k, v in base.items()},
          **{f"module.adapter.{k}": v for k, v in adapter.items()}}
    path = str(tmp_path / "wrapper.pth")
    torch.save(sd, path)
    _assert_same_tree(ckpt.import_pth(path, variant, prefix="adapter"),
                      jax_ckpt.import_pth(path, variant, prefix="adapter"))
    _assert_same_tree(ckpt.import_pth(path, "UNetImproved", prefix="base"),
                      jax_ckpt.import_pth(path, "UNetImproved", prefix="base"))
