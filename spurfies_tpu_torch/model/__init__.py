"""Networks, neural-point scene state, field, sampler and renderer."""
