"""Spec constant tables (ISO/IEC 11172-3): scalefactor bands, Huffman
codebooks, filterbank windows/matrices. All data is generated at import
from closed-form spec formulas, or committed as extracted spec data with
provenance notes (see tools/).

Copy of mp3tpu.tables, kept in the port so that it imports nothing of
the JAX package; the code is the same.
"""

from . import huffman, sfb, synth_window  # noqa: F401
