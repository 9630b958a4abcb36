from .h1 import UnitreeH1, UnitreeH1Simplified, UnitreeH1WithHandsUpperBodyOnly
