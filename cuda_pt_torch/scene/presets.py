"""Material presets: conductor spectral eta/k and dielectric Cauchy terms
(port of cuda_pt_tpu/scene/presets.py, the same tables).

Name parity with the reference preset tables (src/core/preset_params.cuh:
34-83) so its scene XMLs parse unchanged. Values are standard published
optical constants (refractiveindex.info / common renderer data) sampled at
RGB wavelengths (~645/526/444 nm) — physical data, not reference code.
"""

# conductor: name -> (eta_rgb, k_rgb)
CONDUCTORS = {
    "Ag": ((0.1553, 0.1163, 0.1381), (4.8283, 3.1222, 2.1457)),
    "Al": ((1.3456, 0.9652, 0.6177), (7.4746, 6.3995, 5.3031)),
    "Au": ((0.1431, 0.3749, 1.4424), (3.9831, 2.3857, 1.6032)),
    "Cr": ((4.3696, 2.9167, 1.6547), (5.2064, 4.2313, 3.7549)),
    "Cu": ((0.2004, 0.9240, 1.1022), (3.9129, 2.4528, 2.1421)),
    "Ni": ((2.3672, 1.6633, 1.4670), (4.4988, 3.0501, 2.3454)),
    "TiO2": ((2.5823, 2.6372, 2.7338), (1e-4, 1e-4, 1e-4)),
    "W": ((3.6845, 3.4861, 3.2355), (2.9693, 2.7351, 2.5291)),
    "CuO": ((2.6255, 2.5373, 2.4837), (0.5127, 0.5842, 0.7254)),
    "Hg": ((1.8795, 1.4675, 1.1127), (5.1076, 4.3325, 3.5556)),
    "Ir": ((2.5399, 2.1380, 1.8534), (4.6918, 4.2227, 3.7568)),
    "MgO": ((1.7357, 1.7419, 1.7522), (1e-4, 1e-4, 1e-4)),
    "Na": ((0.0495, 0.0551, 0.0608), (2.5434, 2.1951, 1.8618)),
    "SiC": ((2.6398, 2.6667, 2.7086), (1e-4, 1e-4, 1e-4)),
    "V": ((3.4966, 3.6864, 3.3867), (2.9811, 3.0505, 3.3573)),
}

# dispersion: name -> (cauchy_A, cauchy_B [um^2]); published Cauchy
# coefficients for the 8 dielectrics the reference names
# (src/core/preset_params.cuh:74-83 lists the same materials in nm^2).
DISPERSION = {
    "Diamond": (2.3818, 0.0121),
    "DiamondHigh": (2.3600, 0.0310),
    "Silica": (1.4580, 0.00354),
    "Sapphire": (1.7522, 0.00554),
    "Water": (1.3199, 0.00322),
    "Glass-BK7": (1.5046, 0.00420),
    "Glass-BaF10": (1.6700, 0.00743),
    "Glass-SF10": (1.7280, 0.01342),
}
# the reference spells these with underscores — accept both
DISPERSION.update({k.replace("-", "_"): v for k, v in list(DISPERSION.items())})
