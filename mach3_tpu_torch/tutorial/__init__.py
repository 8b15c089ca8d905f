"""The in-repo toy experiment (``toy.py``)."""
