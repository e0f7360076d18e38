"""Collapsed-Gibbs sweeps (sequential scan, blocked tiles) and moves."""
