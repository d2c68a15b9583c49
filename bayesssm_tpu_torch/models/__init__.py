"""Models of the port: distributions, SIR and LGSS."""
