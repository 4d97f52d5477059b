"""A co-assembly's genome bins over one sample set: bin b the E. coli mock's
variant positions (``gen.generate``, which is what ``gen.mock_community``
draws first) at its own V, from a configuration's generator parameters; no
accessory genes, no monomorphic rows."""
from benchmark import gen


def draw(g: dict, seed: int):
    """([Truth of bin b], None): bin b of V = g["V"][b] drawn from
    ``gen.seed_of(seed, 0, b)``, seed the run's --seed (index 0: the inputs,
    as every entry draws them)."""
    return [gen.generate(V=v, S=g["S"], G=g["G"], coverage=g["coverage"],
                         error_rate=g["error_rate"], gamma_alpha=g["gamma_alpha"],
                         seed=gen.seed_of(seed, 0, b), max_alleles=g["max_alleles"])
            for b, v in enumerate(g["V"])], None
