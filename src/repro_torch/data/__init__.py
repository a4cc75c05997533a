"""Synthetic datasets + the paper's benchmark workloads.

movielens.py / tpcxai.py / analytics.py generate deterministic synthetic
catalogs shaped like the paper's datasets (MovieLens-1M, TPCx-AI, Credit
Card / Expedia / Flights), scaled for this container; workloads.py builds
the 12 representative inference queries; templates.py samples the 20-template
random query fleet (Appendix N).
"""
