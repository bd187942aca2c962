"""Model zoo (reference: gluon/model_zoo/)."""
from . import vision
from .vision import get_model
