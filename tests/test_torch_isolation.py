"""The PyTorch port stands alone: importing `paddle_tpu_torch` loads no jax
and nothing of `paddle_tpu` (checked in a subprocess, since this test
process already imported both), no port source imports them, and its entry
points run on the card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "paddle_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tools" / "paddle_gpt_layers.py",
    REPO / "tools" / "paddle_layer_cases.py"]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def test_import_loads_no_jax_or_paddle_tpu_in_a_subprocess():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import paddle_tpu_torch, paddle_tpu_torch.inference.engine\n"
        "import paddle_tpu_torch.nn.rnn, paddle_tpu_torch.nn.initializer\n"
        "import paddle_tpu_torch.nn.layer, paddle_tpu_torch.device.memory\n"
        "sys.path.insert(0, 'tools')\n"
        "import paddle_gpt_layers, paddle_layer_cases\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_neither_jax_nor_paddle_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {n}"


def test_entry_points_default_to_the_card_and_raise_without_one(
        monkeypatch):
    from paddle_tpu_torch import (GenerationEngine, GPTConfig,
                                  GPTForCausalLM, resnet50, resolve_device)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig.tiny(vocab=61, hidden=32, layers=1, heads=2, seq=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    model = GPTForCausalLM(cfg, device="cpu")
    assert model.gpt.wte.weight.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationEngine(model.eval())
    eng = GenerationEngine(model, num_slots=2, block_size=8, device="cpu")
    assert eng.cache.kpool.device.type == "cpu"
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        resolve_device("meta")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet50()
    net = resnet50(num_classes=10, device="cpu")
    assert net.conv1.weight.device.type == "cpu"
    assert net.layer4[2].convbn3.bn._mean.device.type == "cpu"
