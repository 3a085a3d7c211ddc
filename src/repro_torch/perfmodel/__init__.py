"""Analytic performance models of the switch (plain Python)."""
