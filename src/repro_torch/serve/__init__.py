"""Serving layer of the port: the LM batch engine.

The plan server (``plans``, ``zoo``) is not ported yet.
"""

from .engine import Request, ServeConfig, ServeEngine

__all__ = ["Request", "ServeConfig", "ServeEngine"]
