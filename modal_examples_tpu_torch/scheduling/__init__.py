"""Admission for the port's engine."""
