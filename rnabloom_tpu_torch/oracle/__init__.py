"""The decision oracle (``divergence.py``) and its scalar reference model (``refsim.py``)."""
