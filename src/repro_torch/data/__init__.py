"""Datasets: the SOSD surrogates."""
