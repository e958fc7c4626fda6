"""The port's examples (``examples/torch_*.py``), each ``main`` run with
``--device cpu`` at a small size: they import only ``repro_torch`` and
finish with their own checks passing."""

import importlib.util
import sys
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
ARGS = {
    "torch_quickstart": ["--tokens", "256"],
    # 2 pods x 2 ranks, 16 tokens a rank
    "torch_moe_dispatch_demo": ["--ep", "2", "--tokens", "16", "--width",
                                "64"],
    "torch_serve_demo": ["--width", "64", "--prompt-len", "8",
                         "--max-new", "4"],
    "torch_train_100m": ["--tiny"],
}


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(ARGS))
def test_example_runs_on_the_cpu(name, tmp_path, capsys):
    args = ["--device", "cpu"] + ARGS[name]
    if name == "torch_train_100m":
        args += ["--ckpt-dir", str(tmp_path / "ckpt")]
    _load(name).main(args)
    assert "OK" in capsys.readouterr().out or name == "torch_quickstart"


@pytest.mark.parametrize("name", sorted(ARGS))
def test_example_imports_only_the_port(name):
    text = (EXAMPLES / f"{name}.py").read_text()
    imports = [line.split()[1] for line in text.splitlines()
               if line.startswith(("import ", "from "))]
    assert not [m for m in imports
                if m.split(".")[0] in ("jax", "jaxlib", "repro")], imports
    assert any(m.startswith("repro_torch") for m in imports)


def test_examples_raise_without_cuda():
    """No card here: each example's default device raises, as the port's
    entry points do."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for name in sorted(ARGS):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _load(name).main(ARGS[name])
