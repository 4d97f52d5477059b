"""The E. coli mock community and its accessory genes (``gen.mock_community``,
``gen.gene_truth``), from a configuration's generator parameters."""
from benchmark import gen


def draw(g: dict, seed: int):
    truth, rng = gen.mock_community(
        V=g["V"], S=g["S"], G=g["G"], coverage=g["coverage"],
        error_rate=g["error_rate"], gamma_alpha=g["gamma_alpha"],
        max_alleles=g["max_alleles"], seed=seed)
    genes = None
    if g.get("n_genes"):
        genes = gen.gene_truth(rng, truth.counts[:g["V"]], truth.gamma, g["n_genes"])
    return truth, genes
