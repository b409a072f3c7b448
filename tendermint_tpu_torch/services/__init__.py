"""Verifier services of the port."""
