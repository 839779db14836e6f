"""Dimensionless numbers of the Boussinesq system.

Pure-math transcription of the reference's closure formulas
(reference: source/model_data/core_model_data.cc:7-94) — the one part of
the reference SURVEY.md identifies as directly translatable since it is
hardware-independent arithmetic.

All functions are plain Python floats so they can be used at trace time
(static values baked into jitted step functions).
"""

from __future__ import annotations


def reynolds_number(velocity: float, length: float, kinematic_viscosity: float) -> float:
    """Re = u_ref * L_ref / nu   (reference: core_model_data.cc:8-14)."""
    return (velocity * length) / kinematic_viscosity


def peclet_number(velocity: float, length: float, thermal_diffusivity: float) -> float:
    """Pe = u_ref * L_ref / kappa   (reference: core_model_data.cc:17-23)."""
    return (velocity * length) / thermal_diffusivity


def rossby_number(length: float, omega: float, velocity: float) -> float:
    """Ro = u_ref / (L_ref * Omega)   (reference: core_model_data.cc:25-31)."""
    return velocity / (length * omega)


def reference_acceleration(length: float, velocity: float) -> float:
    """a_ref = u_ref^2 / L_ref   (reference: core_model_data.cc:34-39)."""
    return velocity * velocity / length


def grashoff_number(
    dim: int,
    gravity_constant: float,
    expansion_coefficient: float,
    temperature_change: float,
    length: float,
    kinematic_viscosity: float,
) -> float:
    """Gr = g * beta * dT * L^dim / nu   (reference: core_model_data.cc:42-53).

    Note: the reference divides by nu (not nu^2) — we reproduce its
    formula, not the textbook one, for parity.
    """
    return (
        gravity_constant
        * expansion_coefficient
        * temperature_change
        * length**dim
        / kinematic_viscosity
    )


def prandtl_number(kinematic_viscosity: float, thermal_diffusivity: float) -> float:
    """Pr = nu / kappa   (reference: core_model_data.cc:56-61)."""
    return kinematic_viscosity / thermal_diffusivity


def rayleigh_number(
    dim: int,
    gravity_constant: float,
    expansion_coefficient: float,
    temperature_change: float,
    length: float,
    kinematic_viscosity: float,
    thermal_diffusivity: float,
) -> float:
    """Ra = g * beta * dT * L^dim * Pr   (reference: core_model_data.cc:64-74).

    Again the reference's own (non-textbook) formula, kept for parity.
    """
    return (
        gravity_constant
        * expansion_coefficient
        * temperature_change
        * length**dim
        * prandtl_number(kinematic_viscosity, thermal_diffusivity)
    )


def density(
    rho_ref: float,
    expansion_coefficient: float,
    temperature: float,
    temperature_ref: float,
) -> float:
    """Linear Boussinesq density rho(T) = rho * (1 - beta (T - T_ref))
    (reference: core_model_data.cc:77-85)."""
    return rho_ref * (1.0 - expansion_coefficient * (temperature - temperature_ref))


def density_scaling(
    expansion_coefficient: float, temperature, temperature_ref: float
):
    """Dimensionless rho(T)/rho_ref = 1 - beta (T - T_ref)
    (reference: core_model_data.cc:88-94).

    Works elementwise on tensors and arrays.
    """
    return 1.0 - expansion_coefficient * (temperature - temperature_ref)
