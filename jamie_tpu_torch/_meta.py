"""Package metadata.

Reference parity: jamie/_meta.py (version string export). The version is
the one `jamie_tpu` writes into checkpoint headers, so checkpoints of the
two packages carry the same header.
"""

__version__ = '0.1.0'
__reference_version__ = '4.4.5'  # Oafish1/JAMIE version this framework tracks
