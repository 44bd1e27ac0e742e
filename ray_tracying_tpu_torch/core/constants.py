"""Numeric constants pinned to the reference renderer's behavior.

Every constant cites the reference file:line it reproduces so the parity
contract is auditable.  These are semantics constants, not tunables: change
one and image parity with the reference C++ renderer breaks.
"""

# Maximum Whitted recursion depth.  `depth > 10` returns black, so up to 11
# levels of Trace run.  (reference: Code/raytracer.hpp:11, raytracer.cpp:290)
MAX_RECURSION_DEPTH = 10

# Flat background radiance returned on miss.  (Code/raytracer.cpp:297)
BACKGROUND_RGB = (0.1, 0.1, 0.1)

# Display gamma applied at the output boundary; the reference uses 1.1, not
# 2.2.  (Code/raytracer.cpp:446)
GAMMA = 1.1

# Quantization scale: int(clamp01(c) * 255.999).  (Code/raytracer.cpp:453-457)
QUANT_SCALE = 255.999

# Self-intersection offsets along the surface normal for secondary rays:
# shadow and reflection origins are pushed +EPS_N, refraction -EPS_N.
# (Code/raytracer.cpp:112,147,227)
EPS_NORMAL_OFFSET = 1e-4

# Primitive-test minimum ray parameter for sphere and rectangle hits.
# (Code/shapes.cpp:231,310).  NOTE: the cube slab test uses 0.0, not this
# epsilon (Code/shapes.cpp:392), and the legacy plane uses 0.0 too
# (Code/shapes.cpp:459) — reproduced per-primitive in render/intersect.py.
EPS_T_MIN = 1e-3

# Parallel-ray epsilon for slab/plane denominators.
# (Code/shapes.cpp:60,307,369,455)
EPS_PARALLEL = 1e-6

# Glossy reflection rays are traced only if |dir|^2 > 0.001; perturbed rays
# pointing into the surface are zeroed (absorbed).  (Code/raytracer.cpp:322-330)
EPS_GLOSSY_DIR2 = 1e-3

# Refraction rays are traced only if |dir|^2 > 1e-6 (TIR produces a zero
# direction).  (Code/raytracer.cpp:340)
EPS_REFRACT_DIR2 = 1e-6

# Point-in-triangle edge tolerance for the legacy Plane quad test.
# (Code/shapes.cpp:29-37)
EPS_PLANE_EDGE = -1e-6

# Loader divides sphere velocity by 5.  (Code/json_loader.cpp:221-223)
VELOCITY_SCALE = 0.2

# Light attenuation 10*I / (25 + 10*d + 150*d^2) — nonstandard, copied
# exactly.  (Code/raytracer.cpp:262)
ATTEN_NUM = 10.0
ATTEN_C0 = 25.0
ATTEN_C1 = 10.0
ATTEN_C2 = 150.0

# Material defaults when the JSON "material" block is entirely absent.
# (Code/material.hpp:52-70)
MAT_DEFAULTS_NO_BLOCK = dict(
    diffuse_color=(0.8, 0.8, 0.8),
    specular_color=(1.0, 1.0, 1.0),
    k_ambient=0.1,
    k_diffuse=0.9,
    k_specular=0.3,
    shininess=20.0,
    roughness=0.0,
    reflectivity=0.0,
    transparency=0.0,
    refractive_index=1.0,
)

# Per-key defaults used when a "material" block IS present but a key is
# missing — these differ from the class defaults above!
# (Code/json_loader.cpp:45-69)
MAT_DEFAULTS_IN_BLOCK = dict(
    k_ambient=0.1,
    k_diffuse=0.6,
    k_specular=0.6,
    roughness_for_shininess=0.001,  # shininess = 5 / clamp(r, 1e-3, 1)^2
    roughness=0.0,
    reflectivity=0.0,
    transparency=0.0,
    refractive_index=1.0,
)

# Shininess derivation: 5 / clamp(roughness, 0.001, 1)^2.
# (Code/json_loader.cpp:56-61)
SHININESS_NUM = 5.0
SHININESS_R_MIN = 0.001
SHININESS_R_MAX = 1.0

# Camera defaults when keys are missing.  (Code/camera.cpp:30-31)
CAMERA_APERTURE_DEFAULT = 0.0
CAMERA_FOCUS_DIST_DEFAULT = 10.0

# Light radius default (loader), radius > 0 enables spherical-area soft
# shadows.  (Code/json_loader.cpp:136)
LIGHT_RADIUS_DEFAULT = 0.0
