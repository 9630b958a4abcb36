from .koch import Koch
