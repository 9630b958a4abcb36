from .anymal_c import ANYmalC
