"""Point-cloud preparation: the DUSt3R network, global alignment, the
post-processing and the COLMAP converter."""
