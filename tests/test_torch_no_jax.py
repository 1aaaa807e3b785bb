"""The port stands alone: ``repro_torch`` (its trace validator, ``python -m
repro_torch.obs`` and the roofline too), ``chip_smoke.py`` and the rank functions of the
multi-rank tests (``tests/torch_shard_workers.py``,
``tests/torch_serve_workers.py``, ``tests/torch_dryrun_workers.py``)
import neither jax nor anything of the reference package ``repro``; the
dry run sets no environment variable and starts no process group when it
is imported."""
from __future__ import annotations

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax():
    mods = list(_modules())
    assert "repro_torch.serve.engine.engine" in mods and len(mods) > 20
    assert {"repro_torch.core.async_sghmc", "repro_torch.core.ec_sgld", "repro_torch.core.easgd",
            "repro_torch.core.recipe", "repro_torch.models.mlp", "repro_torch.models.resnet",
            "repro_torch.data.pipeline", "repro_torch.data.synthetic",
            "repro_torch.distributed", "repro_torch.distributed.compression",
            "repro_torch.distributed.collectives", "repro_torch.distributed.sharding",
            "repro_torch.launch.mesh", "repro_torch.models.moe",
            "repro_torch.configs.h2o_danube_1_8b", "repro_torch.configs.gemma2_27b",
            "repro_torch.configs.gemma3_27b", "repro_torch.configs.olmoe_1b_7b",
            "repro_torch.configs.grok_1_314b", "repro_torch.models.encdec",
            "repro_torch.configs.xlstm_350m", "repro_torch.configs.qwen2_vl_7b",
            "repro_torch.configs.whisper_base", "repro_torch.launch.specs",
            "repro_torch.obs.sinks", "repro_torch.obs.validate",
            "repro_torch.obs.__main__", "repro_torch.roofline",
            "repro_torch.roofline.analytic", "repro_torch.launch.dryrun",
            "repro_torch.models.spmd"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         cwd=str(ROOT), timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\.|from\s+repro[\s.])",
                        re.MULTILINE)


def test_sources_name_no_jax_or_reference_import():
    # the rank functions of the multi-rank tests run in spawned processes
    # that must stay as light as the port
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "tests" / "torch_shard_workers.py",
                                          ROOT / "tests" / "torch_serve_workers.py",
                                          ROOT / "tests" / "torch_dryrun_workers.py"]
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits
    assert _FORBIDDEN.search("from repro.models import x") and _FORBIDDEN.search("import jax")
    assert not _FORBIDDEN.search("from repro_torch import x")


def test_dryrun_import_sets_nothing():
    """Importing the dry run (the reference's sets ``XLA_FLAGS`` at import)
    leaves the environment and ``torch.distributed`` as they were."""
    code = (
        "import os, torch.distributed as dist\n"
        "before = dict(os.environ)\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.specs, repro_torch.models.spmd\n"
        "assert dict(os.environ) == before\n"
        "assert not dist.is_initialized()\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         cwd=str(ROOT), timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
