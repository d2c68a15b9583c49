"""Convergence diagnostics: multi-chain ESS and split-R-hat."""
