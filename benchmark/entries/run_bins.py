"""The entry ``run_bins``: a closed loop of whole-metagenome runs, one
``desman_tpu_torch.multibin.run_bins_files`` an item, with the sampler
config ``multibin -g G -i iterations`` builds (burn the first half, eta
sampled): every bin's counts CSV read, the bins padded to the largest V on
the device and run as one chain axis, one output directory a bin. The bins
are drawn from the seed (``generators/mock_bins.py``) and written in set-up
under ``TMPDIR``; item k runs them all on seed (--seed, 1, k) into fresh
directories, kept until the judge has read them.

A sweep is one sweep of every bin. The sweep's shape is the bins' own
positions (their sum of V, S, G) and its observed counts are those of the
bins' own rows, so the least time (``peaks``) counts no padded row and the
padding shows as a lost share of the roofline.

Each bin is judged from what the run wrote, as ``judge.bins`` reads a bin:
its Filtered_Tau_star.csv, Gamma_star.csv and Eta_star.csv, and its fit.txt
star loglik less ``reference.coeff`` of its own rows, against the float64
reference on its own unpadded counts (``judge.chains``, a bin and an item
at a time):

- ``ll_gap``: the worst over bins and items; a padded row that leaks into a
  chain's likelihood reads here;
- ``fit_gap``: the median over bins and items;
- ``rows_gap``: the bins whose written tau is not exactly their own
  positions, in order.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from dataclasses import replace

import numpy as np
import torch

from benchmark import gen, judge, reference


class Entry:
    """A closed loop of 12-bin multibin runs."""

    def __init__(self, wl: dict, config: dict, seed: int, device):
        from desman_tpu_torch.sampler import SamplerConfig

        self.wl, self.seed, self.device = wl, seed, torch.device(device)
        self.truths, _ = gen.draw(config, seed)
        self.tmp = tempfile.mkdtemp(prefix="desman_bench_")
        self.files = []
        for b, truth in enumerate(self.truths):
            self.files.append(os.path.join(self.tmp, f"bin_{b}.csv"))
            gen.write_counts_csv(self.files[-1], truth.counts)
        burn = wl["iterations"] // 2
        self.cfg = SamplerConfig(G=wl["G"], burn=burn, samples=wl["iterations"] - burn)
        self.done = []       # the output directories of each finished item
        V, S, _ = zip(*(t.counts.shape for t in self.truths))
        self.shape = (sum(V), S[0], wl["G"])
        self.observed = int(sum((t.counts > 0).sum() for t in self.truths))

    def _run(self, cfg, seed: int, name: str) -> list:
        from desman_tpu_torch.multibin import run_bins_files

        outs = [os.path.join(self.tmp, name, f"bin_{b}") for b in range(len(self.files))]
        run_bins_files(self.files, cfg, outs, seed=seed, kernel=self.wl["kernel"],
                       device=self.device)
        return outs

    def warm(self) -> None:
        """Every bin through a few sweeps: the reads, the padded shape, the
        chain axis's kernels and graphs, the writes."""
        warm = self.wl["warm_sweeps"]
        cfg = replace(self.cfg, burn=warm // 2, samples=warm - warm // 2)
        self._run(cfg, gen.seed_of(self.seed, 2), "warm")
        shutil.rmtree(os.path.join(self.tmp, "warm"))

    def item(self, k: int) -> int:
        self.done.append(self._run(self.cfg, gen.seed_of(self.seed, 1, k), f"item_{k}"))
        return self.cfg.total_sweeps

    def free(self) -> None:
        pass

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)

    def judge(self) -> dict:
        coeffs = [reference.coeff(t.counts) for t in self.truths]
        return self._judge([[_written(out, c) for out, c in zip(outs, coeffs)]
                            for outs in self.done])

    def control(self, prec, items: int) -> dict:
        """The reference sampler in `prec` in the program's place: a chain a
        bin on the bin's own counts, `items` runs of every bin on their own
        seeds, judged alike."""
        from benchmark import reference_sampler

        runs = []
        for k in range(items):
            run = []
            for b, truth in enumerate(self.truths):
                tau, gamma, eta, ll = reference_sampler.chain(
                    truth.counts, self.wl["G"], self.cfg.burn, self.cfg.samples,
                    gen.seed_of(self.seed, 3, k, b), prec, self.device)
                run.append((np.arange(len(tau)), judge.ChainAnswer(
                    tau=tau, gamma=gamma, eta=eta, loglik=ll,
                    sweeps=self.cfg.total_sweeps)))
            runs.append(run)
        return self._judge(runs)

    def _judge(self, runs) -> dict:
        """ll_gap, fit_gap and rows_gap over runs: [[(positions, answer) a
        bin] a run]; {} with no run finished."""
        if not runs:
            return {}
        ll_gaps, fit_gaps, rows_gap = [], [], 0
        for run in runs:
            for truth, (pos, answer) in zip(self.truths, run):
                if not np.array_equal(pos, np.arange(truth.counts.shape[0])):
                    rows_gap += 1
                    continue
                gaps = judge.chains([answer], truth, self.device)
                ll_gaps.append(gaps["ll_gap"])
                fit_gaps.append(gaps["fit_gap"])
        return {"ll_gap": max(ll_gaps, default=float("inf")),
                "fit_gap": float(np.median(fit_gaps)) if fit_gaps else float("inf"),
                "rows_gap": float(rows_gap)}

    def spans(self) -> dict:
        return {}


def _written(out: str, coeff: float):
    """(positions, answer) of a bin's output directory: its star state and
    its fit.txt star loglik less `coeff`, the multinomial coefficients of
    the bin's own rows, which the star loglik written there holds."""
    pos, tau = judge._tau_star(os.path.join(out, "Filtered_Tau_star.csv"))
    gamma = judge._matrix(os.path.join(out, "Gamma_star.csv"))
    eta = judge._matrix(os.path.join(out, "Eta_star.csv"))
    return pos, judge.ChainAnswer(tau=tau, gamma=gamma, eta=eta,
                                  loglik=judge._star_loglik(os.path.join(out, "fit.txt"))
                                  - coeff, sweeps=0)
