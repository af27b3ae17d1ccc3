"""Implicit differentiation of the KKT conditions (port of diff/)."""
