"""PMMH: priors, transforms and the PMMH sampling phase."""
