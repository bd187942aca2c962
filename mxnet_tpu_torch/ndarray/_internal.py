"""Generated ``mx.nd._internal._*`` op functions (ndarray/register.py)."""
