"""A family's graph from its shapes alone, one module per family (named as
the configuration's ``family``): ``layers(config, batch)``, the operations
and bytes a forward needs, so that they read the same whatever implements
the layers; ``plan(config)``, the weight generator's walk; and, where the
family has train cells, ``qat_key(name)``, the benchmark's key of the
program trainer's leaf ``name``."""
