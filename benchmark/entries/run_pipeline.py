"""The entry ``run_pipeline``: a closed loop of genome bins, one
``desman_tpu_torch.pipeline.run_pipeline`` an item, from its counts CSV
through the filter, the G grid, the selection and GeneAssign, into a fresh
output directory under ``TMPDIR``. The bins' mocks are drawn from (--seed,
bin) and written in set-up; item k runs bin k modulo their number.
"""
from __future__ import annotations

import os
import shutil
import tempfile

import torch

from benchmark import gen, judge


class Entry:
    """A closed loop of genome bins through the whole pipeline."""

    shape, observed = (), 0     # no one sweep shape: no least time

    def __init__(self, wl: dict, config: dict, seed: int, device):
        self.wl, self.config, self.seed = wl, config, seed
        self.device = torch.device(device)
        self.tmp = tempfile.mkdtemp(prefix="desman_bench_")
        self.bins = []
        for b in range(wl["bins_written"]):
            truth, genes = gen.draw(config, gen.seed_of(seed, 0, b))
            counts = os.path.join(self.tmp, f"counts_{b}.csv")
            gene_cov = os.path.join(self.tmp, f"genes_{b}.csv")
            gen.write_counts_csv(counts, truth.counts)
            gen.write_gene_cov_csv(gene_cov, genes[1])
            self.bins.append(dict(truth=truth, genes=genes[1], counts=counts,
                                  gene_cov=gene_cov))
        self.done = []       # (bin index, output dir, summary)

    def _config(self, b: int, out: str, iterations: int) -> dict:
        wl = self.wl
        return {
            "counts": self.bins[b]["counts"], "output_dir": out,
            "filter": {k: wl["filter"][k] for k in ("min_coverage", "q_cutoff")},
            "grid": {**wl["grid"], "iterations": iterations},
            "genes": {**wl["genes"], "coverage_csv": self.bins[b]["gene_cov"]},
        }

    def warm(self) -> None:
        """Bin 0 with the grid's sweeps cut to a few: every G's shapes, the
        filter's and GeneAssign's."""
        from desman_tpu_torch.pipeline import run_pipeline

        out = os.path.join(self.tmp, "warm")
        run_pipeline(self._config(0, out, self.wl["warm_sweeps"]), device=self.device)
        shutil.rmtree(out)

    def item(self, k: int) -> int:
        """Bin k (the mocks written in set-up in turn), in a fresh directory,
        kept until the judge has read it."""
        from desman_tpu_torch.pipeline import run_pipeline

        b = k % len(self.bins)
        out = os.path.join(self.tmp, f"bin_{k}")
        summary = run_pipeline(self._config(b, out, self.wl["grid"]["iterations"]),
                               device=self.device)
        self.done.append((b, out, summary))
        return int(summary["grid_sweeps"])

    def free(self) -> None:
        pass

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)

    def judge(self) -> dict:
        return self.control(None)

    def control(self, prec, items: int = 0) -> dict:
        """The reference filter, loglik and GeneAssign in `prec` in the
        program's place (None: the program's own answers)."""
        return judge.bins([(self.bins[b], out, s) for b, out, s in self.done],
                          self.wl, self.config["generator"]["G"], prec)

    def spans(self) -> dict:
        """The pipeline summary's walls of every finished bin."""
        return {"grid_wall_s": [s["grid_wall_s"] for _, _, s in self.done],
                "genes_wall_s": [s["genes_wall_s"] for _, _, s in self.done
                                 if "genes_wall_s" in s]}
