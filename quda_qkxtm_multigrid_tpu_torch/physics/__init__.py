"""QKXTM measurements: propagators and hadron contractions."""
