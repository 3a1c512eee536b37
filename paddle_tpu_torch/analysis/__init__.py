"""Static checks of the port (counterpart of ``paddle_tpu/analysis``).

Only the PT034 KV-pool sizing check is ported (``analysis/memory.py``);
the program verifier and the planner's other codes (PT030-PT033) are
not. Importing this package imports nothing heavy.
"""
from __future__ import annotations
