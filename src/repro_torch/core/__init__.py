"""Secure K-means core: ring, sharing, dealer, protocols and the fit."""
