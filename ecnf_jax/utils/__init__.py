from ecnf_jax.utils.compile_cache import enable_persistent_compilation_cache
from ecnf_jax.utils.test_utils import (
    random_rotation_matrix,
    assert_function_is_equivariant,
    get_rotation_matrix_from_angle_2d,
    get_rotation_matrix_from_z_a1_a2,
)
