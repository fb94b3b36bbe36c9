"""Histograms and Fortio-style result documents."""
