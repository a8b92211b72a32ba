"""Model configurations: the schema and registry (`base`) and the ten
architectures of the LM substrate, each a FULL config and a REDUCED sibling
for tests (the JAX package's `configs/`, field for field)."""
