"""The CUDA launcher twins (scripts/cuda/*.sh, *.ps1) against the port's
parsers and their originals in scripts/. JAX-free: it runs where the card is.

Each twin calls at least one ``image_denoising_tpu_torch.cli`` module; the
CLI's own parser accepts every flag and value it passes (strictly, even
where the CLI itself would drop an unknown flag); and it passes the same
flags and values as its original, to the same CLI, apart from the serving
presets' differences listed in ``SERVING_TWINS``.
"""
import argparse
import glob
import importlib
import os

import pytest

from image_denoising_tpu_torch.cli.launchers import flag_values, read_launcher

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
TWINS = os.path.join(SCRIPTS, "cuda")

# twin → (original, flags added with their values, flags dropped): the
# port's serving presets, each listed in its twin's header comment
SERVING_TWINS = {
    "denoise_cuda.sh": ("denoise_tpu.sh", {"--host_workers": "4"}, ()),
    "eval_704_cuda_fast.sh": ("eval_704_tpu_fast.sh", {"--device_metrics": None}, ()),
    "eval_704_iqsl_memory_cuda_fast.sh": ("eval_704_iqsl_memory_tpu_fast.sh",
                                          {"--device_metrics": None},
                                          ("--pallas_retrieval",)),
}


def _launchers(root):
    return sorted(glob.glob(os.path.join(root, "*.sh")) + glob.glob(os.path.join(root, "*.ps1")))


def _twin_of(original):
    name = os.path.basename(original)
    renamed = {orig: twin for twin, (orig, _, _) in SERVING_TWINS.items()}
    return os.path.join(TWINS, renamed.get(name, name))


class _Captured(Exception):
    pass


def _parser(module_name):
    """The parser the CLI's ``parse_args`` builds, caught before it parses."""
    mod = importlib.import_module(module_name)
    got = {}

    def catch(self, args=None, namespace=None):
        got["parser"] = self
        raise _Captured

    saved = argparse.ArgumentParser.parse_args, argparse.ArgumentParser.parse_known_args
    argparse.ArgumentParser.parse_args = argparse.ArgumentParser.parse_known_args = catch
    try:
        mod.parse_args([])
    except _Captured:
        pass
    finally:
        argparse.ArgumentParser.parse_args, argparse.ArgumentParser.parse_known_args = saved
    return got["parser"]


def test_every_original_has_a_twin():
    originals = _launchers(SCRIPTS)
    assert len(originals) == 24
    assert sorted(_twin_of(p) for p in originals) == _launchers(TWINS)


@pytest.mark.parametrize("path", _launchers(TWINS), ids=os.path.basename)
def test_twin_parses_with_the_port_cli(path):
    calls = read_launcher(path)
    assert calls, f"{os.path.basename(path)} invokes no CLI"
    for module, argv in calls:
        assert module.startswith("image_denoising_tpu_torch.cli."), module
        parser = _parser(module)
        try:
            opt = parser.parse_args(argv)  # strict: an unknown flag exits
        except SystemExit as e:
            raise AssertionError(f"{os.path.basename(path)}: {module} refuses {argv}") from e
        assert opt.device == "cuda"  # the twins run on the card


@pytest.mark.parametrize("original", _launchers(SCRIPTS), ids=os.path.basename)
def test_twin_passes_its_originals_flags(original):
    twin = _twin_of(original)
    _, added, dropped = SERVING_TWINS.get(os.path.basename(twin), (None, {}, ()))
    want = []
    for module, argv in read_launcher(original):
        flags = {k: v for k, v in flag_values(argv).items() if k not in dropped}
        flags.update(added)
        want.append((module.replace("image_denoising_tpu.cli.",
                                    "image_denoising_tpu_torch.cli."), flags))
    got = [(module, flag_values(argv)) for module, argv in read_launcher(twin)]
    assert got == want


def test_read_launcher_expands_variables(tmp_path):
    """bash ``NAME=value`` / ``${NAME}`` and PowerShell ``$NAME = value``,
    quotes, trailing comments and commented-out continuation lines."""
    sh = tmp_path / "a.sh"
    sh.write_text('#!/bin/bash\nset -e\nDIR="./d x"   # a comment\nN=48\n'
                  'python3 -m m.cli.x \\\n  --data_dir "${DIR}" \\\n  --n $N \\\n'
                  '  --flag\n  # --dropped \\\n  # --also 1\n')
    ps = tmp_path / "a.ps1"
    ps.write_text('$ErrorActionPreference = "Stop"\n$DIR = "./d"\n'
                  'python3 -m m.cli.y `\n  --data_dir "$DIR" `\n  --k -8\n')
    assert read_launcher(str(sh)) == [("m.cli.x", ["--data_dir", "./d x", "--n", "48",
                                                   "--flag"])]
    assert read_launcher(str(ps)) == [("m.cli.y", ["--data_dir", "./d", "--k", "-8"])]
    assert flag_values(["--a", "1", "--b", "--c", "-8"]) == {"--a": "1", "--b": None,
                                                            "--c": "-8"}
