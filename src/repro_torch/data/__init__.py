"""Datasets (SOSD surrogates) and the LM data pipeline."""
