"""Compatibility shim: the second trace backend is named PTF2 (see
utils/trace_ptf2.py — a private format following OTF2's architecture, NOT
readable by OTF2 tools; the old module name oversold it)."""

from .trace_ptf2 import *                                    # noqa: F401,F403
from .trace_ptf2 import read_archive, write_archive          # noqa: F401
