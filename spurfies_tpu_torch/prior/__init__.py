"""Local-geometry-prior pretraining (port of ``spurfies_tpu/prior``)."""
