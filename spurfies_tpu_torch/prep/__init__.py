"""Point-cloud preparation (the spacing subsample the synthetic scene uses)."""
