"""Figures and pictures: the paper's CSV-driven figures (``plotting``) and
the MAE reconstruction pictures (``visualize``)."""
