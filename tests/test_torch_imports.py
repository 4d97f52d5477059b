"""The PyTorch port stands alone: it imports neither jax, pandas nor the JAX
package, and its configuration dataclasses match the JAX package's."""
import dataclasses
import os
import re
import subprocess
import sys

import pytest

from torch_helpers import REPO

PORT = os.path.join(REPO, "desman_tpu_torch")
MODULES = [
    "desman_tpu_torch", "desman_tpu_torch.utils", "desman_tpu_torch.io",
    "desman_tpu_torch.synth", "desman_tpu_torch.likelihood",
    "desman_tpu_torch.diagnostics", "desman_tpu_torch.validation",
    "desman_tpu_torch.nmf", "desman_tpu_torch.ops",
    "desman_tpu_torch.ops._build", "desman_tpu_torch.ops.tau_kernel",
    "desman_tpu_torch.ops.swap_kernel", "desman_tpu_torch.ops.gamma_kernel",
    "desman_tpu_torch.ops.fused_sweep", "desman_tpu_torch.ops.tau_topk",
    "desman_tpu_torch.sampler", "desman_tpu_torch.resident",
    "desman_tpu_torch.checkpoint", "desman_tpu_torch.converge",
    "desman_tpu_torch.convert", "desman_tpu_torch.run",
    "desman_tpu_torch.filter", "desman_tpu_torch.model_selection",
    "desman_tpu_torch.pipeline", "desman_tpu_torch.cli",
    "desman_tpu_torch.geneassign", "desman_tpu_torch.genecov",
    "desman_tpu_torch.kernel_bench", "desman_tpu_torch.native",
    "desman_tpu_torch.pileup", "desman_tpu_torch.strainfasta",
    "desman_tpu_torch.profiling", "desman_tpu_torch.multibin",
    "desman_tpu_torch.parallel", "desman_tpu_torch.parallel.mesh",
    "desman_tpu_torch.parallel.distributed", "desman_tpu_torch.parallel.sharded",
    "desman_tpu_torch.parallel.shard_ckpt", "desman_tpu_torch.baseline_numpy",
    "desman_tpu_torch.bench", "desman_tpu_torch.complete_example",
    "desman_tpu_torch.bench_suite", "desman_tpu_torch.make_testdata",
    "desman_tpu_torch.profile_sweep",
]


def test_import_pulls_in_no_jax_or_pandas():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in ('jax', 'pandas', 'desman_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|pandas|desman_tpu)(\.|\s|$)", re.MULTILINE)


def _sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, PORT))
def test_source_imports_nothing_of_jax(path):
    with open(path) as f:
        hits = _FORBIDDEN.findall(f.read())
    assert not hits, f"{path} imports {hits}"


@pytest.mark.parametrize("name", ["sampler.SamplerConfig", "run.RunConfig",
                                  "filter.FilterConfig",
                                  "geneassign.GeneAssignConfig"])
def test_config_fields_match_the_jax_package(name):
    import importlib

    mod, cls = name.split(".")
    ours = getattr(importlib.import_module(f"desman_tpu_torch.{mod}"), cls)
    theirs = getattr(importlib.import_module(f"desman_tpu.{mod}"), cls)

    def spec(c):
        return [(f.name, f.default) for f in dataclasses.fields(c)]

    assert spec(ours) == spec(theirs)


def test_exports_hold_the_jax_packages():
    """The port's package exports every name of the JAX package's
    ``__all__``; its ``parallel`` package every run entry point of JAX's
    (the JAX-only placement helpers, ``shard_counts``/``shard_keys``/
    ``make_*_sweep_sharded``, have no counterpart: a rank holds its block)."""
    import desman_tpu
    import desman_tpu.parallel
    import desman_tpu_torch
    import desman_tpu_torch.parallel

    assert set(desman_tpu.__all__) <= set(desman_tpu_torch.__all__)
    for name in desman_tpu_torch.__all__:
        assert callable(getattr(desman_tpu_torch, name)), name
    runs = {n for n in desman_tpu.parallel.__all__ if n.startswith("run_")}
    assert runs <= set(desman_tpu_torch.parallel.__all__)
    from desman_tpu_torch import run_chain_pt, run_chains  # noqa: F401
