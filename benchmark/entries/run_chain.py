"""The entry ``run_chain``: a closed loop of one-chain
``desman_tpu_torch.sampler.run_chain`` runs, one an item, with the sampler
config ``desman -g G -i iterations`` builds without ``-e``. The counts stay
on the device for the run; chain k's generator seed comes from (--seed, k).
An item ends when its loglik trace and posterior summaries are on the host.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from benchmark import gen, judge


class Entry:
    """A closed loop of one-chain runs."""

    def __init__(self, wl: dict, config: dict, seed: int, device):
        from desman_tpu_torch.run import RunConfig, sampler_config

        self.wl, self.seed, self.device = wl, seed, torch.device(device)
        truth, _ = gen.draw(config, gen.seed_of(seed, 0))
        rows = config["generator"]["V"] if wl.get("positions") == "variant" else None
        self.truth = gen.Truth(tau=truth.tau[:rows], gamma=truth.gamma, eta=truth.eta,
                               counts=truth.counts[:rows])
        self.n = torch.as_tensor(self.truth.counts, device=self.device).to(torch.float32)
        self.cfg = sampler_config(RunConfig(G=wl["G"], iterations=wl["iterations"]))
        self.answers = []
        # the sweep's shape and observed counts, for its least time (peaks)
        self.shape = (*self.truth.counts.shape[:2], wl["G"])
        self.observed = int((self.truth.counts > 0).sum())

    def warm(self) -> None:
        """One short chain through burn-in and sampling, on its own seed."""
        cfg = replace(self.cfg, burn=self.wl["warm_sweeps"] // 2,
                      samples=self.wl["warm_sweeps"] - self.wl["warm_sweeps"] // 2)
        self._chain(cfg, gen.seed_of(self.seed, 2))

    def _chain(self, cfg, seed: int) -> dict:
        from desman_tpu_torch.sampler import chain_generator, run_chain

        res = run_chain(self.n, cfg, chain_generator(seed, self.device),
                        kernel=self.wl["kernel"])
        host = {k: getattr(res, k).cpu().numpy() for k in (
            "tau_star", "gamma_star", "eta_star", "star_loglik", "loglik_trace",
            "tau_mean", "gamma_mean", "eta_mean")}
        return host

    def item(self, k: int) -> int:
        host = self._chain(self.cfg, gen.seed_of(self.seed, 1, k))
        self.answers.append(judge.ChainAnswer(
            tau=host["tau_star"], gamma=host["gamma_star"], eta=host["eta_star"],
            loglik=float(host["star_loglik"]), sweeps=int(host["loglik_trace"].size)))
        return self.cfg.total_sweeps

    def free(self) -> None:
        del self.n

    def close(self) -> None:
        pass

    def judge(self) -> dict:
        return judge.chains(self.answers, self.truth, self.device)

    def control(self, prec, items: int) -> dict:
        """The reference sampler in `prec` in the program's place:
        `items` chains of the cell's config on their own seeds, judged
        alike."""
        from benchmark import reference_sampler

        answers = []
        for k in range(items):
            tau, gamma, eta, ll = reference_sampler.chain(
                self.truth.counts, self.wl["G"], self.cfg.burn, self.cfg.samples,
                gen.seed_of(self.seed, 3, k), prec, self.device)
            answers.append(judge.ChainAnswer(tau=tau, gamma=gamma, eta=eta, loglik=ll,
                                             sweeps=self.cfg.total_sweeps))
        return judge.chains(answers, self.truth, self.device)

    def spans(self) -> dict:
        return {}
