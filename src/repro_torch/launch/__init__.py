"""Launch side of the port: the training launcher (`train`) and the H100
constants of the roofline (`roofline.py`)."""
