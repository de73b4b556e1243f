"""Unit system and physical constants.

We adopt the OpenMM "MD unit" system so that energies/temperatures are directly
comparable with the reference stack (atomsmm is a layer over OpenMM — see
SURVEY.md §1):

    length  : nanometer (nm)
    time    : picosecond (ps)
    mass    : atomic mass unit (amu, g/mol)
    charge  : proton charge (e)
    energy  : kilojoule/mole (kJ/mol)
    temperature : kelvin (K)

Derived: velocity nm/ps, force kJ/mol/nm, pressure kJ/mol/nm^3 (converted to
bar via PRESSURE_IN_BAR).
"""

# Boltzmann constant, kJ/(mol K)  (CODATA 2018, matches OpenMM's MOLAR_GAS_CONSTANT_R)
BOLTZMANN = 8.31446261815324e-3

# Coulomb prefactor 1/(4 pi eps0) in kJ nm / (mol e^2)  (OpenMM's ONE_4PI_EPS0)
ONE_4PI_EPS0 = 138.935456

# 1 kJ/mol/nm^3 in bar
PRESSURE_IN_BAR = 16.6054  # = 1e25 / 6.02214076e23 * 1e-2  (kJ/mol/nm^3 -> bar)

# femtoseconds per picosecond, handy for step sizes
FEMTOSECOND = 1e-3  # ps
