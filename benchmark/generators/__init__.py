"""The benchmark's input generators, one module a configuration's
generator ``kind``, each with ``draw(generator, seed) -> (Truth, genes)``
(``gen.draw``)."""
