// K3 in f64: the kernels of getrfnp.cu (which says what they do), built
// into a library of their own so that it compiles beside the f32 one.

#define RL_GETRFNP_F64
#include "getrfnp.cu"

extern "C" {

int rl_getrfnp_f64(const void* M, void* F, void* s, int k, void* stream) {
  return launch_getrfnp<double>(M, F, s, k, stream);
}

int rl_getrfnp_flat_f64(const void* M, void* F, void* s, int k,
                        void* stream) {
  return launch_getrfnp_flat<double>(M, F, s, k, stream);
}

}  // extern "C"
