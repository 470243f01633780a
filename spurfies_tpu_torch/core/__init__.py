"""Camera, density, quadrature, encoding and metric primitives."""
