"""scripts/cuda/convergence.py on the CPU: its dataset byte for byte the
JAX script's (scripts/tpu_n2n_convergence.py::make_dataset), its pass rule,
and its three legs at a tiny size (n_feature 8, 64², 2 epochs), each giving
the JSON line's fields."""
import json
import os
from pathlib import Path

import pytest
import torch

from _torch_port_helpers import load_script, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def conv():
    return load_script(REPO / "scripts" / "cuda" / "convergence.py")


def test_dataset_is_byte_equal_to_the_jax_script(conv, tmp_path):
    jax_script = load_script(REPO / "scripts" / "tpu_n2n_convergence.py")
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    conv.make_dataset(str(ours), conv.N_FRAMES, 128, conv.SIGMA)
    jax_script.make_dataset(str(theirs), 16, 128)
    for sub in ("clean", "noise"):
        names = sorted(os.listdir(ours / sub))
        assert names == sorted(os.listdir(theirs / sub)) and len(names) == 16
        for f in names:
            assert (ours / sub / f).read_bytes() == (theirs / sub / f).read_bytes(), f


def test_pass_rule_is_the_jax_scripts(conv):
    assert conv.passed(20.0, {15: 21.5, 30: 21.2, 45: 21.4, 60: 21.4})
    assert not conv.passed(20.0, {15: 21.5, 60: 21.0})   # more than 1 dB, but 0.5 below
    assert not conv.passed(20.0, {15: 19.0, 60: 20.9})   # less than 1 dB of gain
    assert conv.passed(20.0, {"1": 21.05, "2": 20.86, "10": 21.01})


@pytest.fixture(scope="module")
def legs(conv, tmp_path_factory):
    work = tmp_path_factory.mktemp("convergence")
    root = str(work / "data")
    conv.make_dataset(root, conv.N_FRAMES, 64, conv.SIGMA)
    noisy = conv.noisy_psnr(root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(conv, "N_FEATURE", dict.fromkeys(conv.N_FEATURE, 8))
        return noisy, {leg: conv.run_leg(leg, root, str(work), n_epoch=2, device="cpu",
                                         noisy=noisy)
                       for leg, _, _ in conv.LEGS}


@pytest.mark.parametrize("leg", ["n2n", "structure_float32", "structure_bfloat16"])
def test_legs_run_on_the_cpu(conv, legs, leg):
    noisy, results = legs
    res = results[leg]
    line = json.loads(json.dumps({k: v for k, v in res.items() if k != "final_ckpt"}))
    assert line["noisy_psnr"] == noisy and 19.0 < noisy < 22.0  # sigma 25 on 8 bits
    assert sorted(line["psnr_by_epoch"]) == ["1", "2"]
    assert line["final_gain_db"] == pytest.approx(line["psnr_by_epoch"]["2"] - noisy)
    assert line["pass"] == conv.passed(noisy, line["psnr_by_epoch"])
    assert line["n_feature"] == 8 and line["n_epoch"] == 2
    assert res["final_ckpt"].endswith("epoch_model_002.ckpt")


def test_main_needs_a_card_unless_told(conv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert conv.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_main_prints_one_line_per_leg(conv, capsys, monkeypatch):
    """``main`` runs every leg of ``LEGS`` (here the N2N leg alone, at
    n_feature 8) and prints its JSON line."""
    monkeypatch.setattr(conv, "LEGS", conv.LEGS[:1])
    monkeypatch.setattr(conv, "N_FEATURE", {"n2n": 8})
    rc = conv.main(["--device", "cpu", "--n_epoch", "1", "--hw", "64"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"kind": "convergence"')]
    assert len(lines) == 1 and lines[0]["leg"] == "n2n" and lines[0]["n_feature"] == 8
    assert rc == (0 if lines[0]["pass"] else 1)
