"""Launch-side constants of the port (`roofline.py`)."""
