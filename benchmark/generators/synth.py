"""The synthetic metagenome (``gen.generate``), from a configuration's
generator parameters; no accessory genes."""
from benchmark import gen


def draw(g: dict, seed: int):
    return gen.generate(V=g["V"], S=g["S"], G=g["G"], coverage=g["coverage"],
                        error_rate=g["error_rate"], gamma_alpha=g["gamma_alpha"],
                        seed=seed, max_alleles=g["max_alleles"]), None
