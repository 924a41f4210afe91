"""Training data for the port's models (the matcher's so far)."""

from .render_domain import harvest_matching_pair, match_prf, mutual_nn_prf

__all__ = ["harvest_matching_pair", "match_prf", "mutual_nn_prf"]
