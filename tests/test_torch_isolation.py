"""The port stands alone: no module of `src/repro_torch/` nor `chip_smoke.py`
imports JAX or the reference package, statically or at run time, nor the
`msgpack` package (the checkpoint format has its own codec)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT = re.compile(r"^\s*(import|from) (jax|repro)(\.|\s|$)")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def test_no_jax_or_reference_import_in_the_source():
    offenders = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
                 for p in _port_files()
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if IMPORT.match(line)]
    assert offenders == []


def test_importing_every_port_module_loads_neither_jax_nor_repro():
    mods = _port_modules()
    assert {"repro_torch.kernels.ops", "repro_torch.models.moe",
            "repro_torch.configs.deepseek_moe_16b",
            "repro_torch.models.decoding", "repro_torch.core.delta",
            "repro_torch.serve", "repro_torch.serve.engine",
            "repro_torch.serve.scheduler", "repro_torch.serve.paging",
            "repro_torch.serve.deltas", "repro_torch.serve.sampling",
            "repro_torch.serve.journal",
            "repro_torch.launch.serve", "repro_torch.models.rwkv6",
            "repro_torch.configs.rwkv6_3b", "repro_torch.models.mamba",
            "repro_torch.configs.gemma3_4b",
            "repro_torch.configs.jamba_1_5_large_398b",
            "repro_torch.configs.nemotron_4_15b",
            "repro_torch.configs.command_r_35b",
            "repro_torch.configs.llama4_scout_17b_a16e",
            "repro_torch.configs.musicgen_medium",
            "repro_torch.configs.qwen2_vl_7b", "repro_torch.checkpoint",
            "repro_torch.checkpoint.manager",
            "repro_torch.checkpoint.msgpack", "repro_torch.runtime",
            "repro_torch.runtime.fault",
            "repro_torch.runtime.chaos", "repro_torch.launch.specs",
            "repro_torch.launch.dryrun",
            "repro_torch.launch.trace_analysis"} <= set(mods)
    assert len(mods) > 15
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
        "                                    'msgpack'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_refuses_to_run_without_a_card():
    """No CUDA here: chip_smoke.py exits non-zero and prints no result."""
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ,
                                               CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
