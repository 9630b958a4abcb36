from .trifingerpro import TriFingerPro
