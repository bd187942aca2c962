"""Generated ``mx.nd.*`` op functions (ndarray/register.py)."""
