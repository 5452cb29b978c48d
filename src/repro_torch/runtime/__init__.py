"""Serving runtime of the port: page pool, step builders, scheduler, engine."""
