"""Eval renderer (``make_render_fn``); the trainer is the training slice's."""
