"""Planner: the catalog, the packing problem, the exact solver and the
H100 catalog the serving measurements are packed onto."""
