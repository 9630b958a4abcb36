from .dclaw import DClaw
