// Public C++ custom-op API (header-only).
//
// The port's copy of paddle_tpu/utils/cpp_extension/include/pd_extension.h,
// the counterpart of the reference's extension surface:
//   paddle/fluid/extension/include/ext_op_meta_info.h:502 (PD_BUILD_OP ->
//   OpMetaInfoMap) and framework/custom_operator.cc:511,867 (runtime .so
//   load + registration).
//
// Design: custom kernels run on the HOST (C++). The port's loader makes
// each op a torch.library custom op (shapes from pd_infer_shape for its
// fake implementation, the grad kernel as its autograd formula); the JAX
// package's wires the same kernels in through jax.pure_callback. The C ABI
// below (PDTensor, the dtype codes, pd_num_ops / pd_op_* / pd_run) is the
// JAX package's, unchanged, so one source builds against either header.
//
// Author-facing usage:
//
//   #include "pd_extension.h"
//   static int relu_fwd(const PDTensor* ins, int n_in,
//                       PDTensor* outs, int n_out) {
//     const float* x = (const float*)ins[0].data;
//     float* y = (float*)outs[0].data;
//     for (int64_t i = 0; i < pd_numel(&ins[0]); i++)
//       y[i] = x[i] > 0 ? x[i] : 0;
//     return 0;
//   }
//   PD_BUILD_OP(custom_relu, 1, 1, relu_fwd);
//   PD_BUILD_GRAD_OP(custom_relu, 2, 1, relu_bwd);  // ins: (x, dy) -> dx
//
#ifndef PD_EXTENSION_H_
#define PD_EXTENSION_H_

#include <cstdint>
#include <cstring>
#include <vector>

#define PD_MAX_DIMS 8

// dtype codes (must match python loader)
enum PDDtype : int32_t {
  PD_FLOAT32 = 0,
  PD_FLOAT64 = 1,
  PD_INT32 = 2,
  PD_INT64 = 3,
};

typedef struct PDTensor {
  void* data;
  int64_t ndim;
  int64_t shape[PD_MAX_DIMS];
  int32_t dtype;
} PDTensor;

static inline int64_t pd_numel(const PDTensor* t) {
  int64_t n = 1;
  for (int64_t i = 0; i < t->ndim; i++) n *= t->shape[i];
  return n;
}

// kernel: fill outs[i].data (buffers pre-allocated by the caller per the
// inferred shapes). Return 0 on success.
typedef int (*PDKernelFn)(const PDTensor* ins, int n_ins, PDTensor* outs,
                          int n_outs);

// optional shape inference: given input shapes, fill output shapes.
// Default (null) = every output takes input 0's shape/dtype.
typedef int (*PDInferFn)(const PDTensor* ins, int n_ins, PDTensor* outs,
                         int n_outs);

namespace pd_ext {

struct OpRec {
  const char* name;
  int n_inputs;
  int n_outputs;
  PDKernelFn fwd;
  PDInferFn infer;
  int grad_n_inputs;
  int grad_n_outputs;
  PDKernelFn bwd;
};

inline std::vector<OpRec>& registry() {
  static std::vector<OpRec> ops;
  return ops;
}

inline OpRec* find(const char* name) {
  for (auto& r : registry())
    if (!strcmp(r.name, name)) return &r;
  return nullptr;
}

struct Registrar {
  Registrar(const char* name, int n_in, int n_out, PDKernelFn fn,
            PDInferFn infer = nullptr) {
    OpRec* r = find(name);
    if (!r) {
      registry().push_back(OpRec{name, n_in, n_out, fn, infer, 0, 0,
                                 nullptr});
    } else {
      r->n_inputs = n_in;
      r->n_outputs = n_out;
      r->fwd = fn;
      r->infer = infer;
    }
  }
};

struct GradRegistrar {
  GradRegistrar(const char* name, int n_in, int n_out, PDKernelFn fn) {
    OpRec* r = find(name);
    if (!r) {
      registry().push_back(OpRec{name, 0, 0, nullptr, nullptr, n_in, n_out,
                                 fn});
      r = &registry().back();
    } else {
      r->grad_n_inputs = n_in;
      r->grad_n_outputs = n_out;
      r->bwd = fn;
    }
  }
};

}  // namespace pd_ext

#define PD_CONCAT_(a, b) a##b
#define PD_CONCAT(a, b) PD_CONCAT_(a, b)

// PD_BUILD_OP(name, n_inputs, n_outputs, kernel_fn[, infer_fn])
#define PD_BUILD_OP(op, n_in, n_out, ...)                                  \
  static ::pd_ext::Registrar PD_CONCAT(__pd_reg_, op){#op, n_in, n_out,    \
                                                      __VA_ARGS__};
#define PD_BUILD_OP_INFER(op, n_in, n_out, fn, infer)                      \
  static ::pd_ext::Registrar PD_CONCAT(__pd_reg_, op){#op, n_in, n_out,    \
                                                      fn, infer};

// grad kernel inputs are (forward inputs..., grad_outputs...) and its
// outputs are grads w.r.t. the forward inputs (reference grad-op contract)
#define PD_BUILD_GRAD_OP(op, n_in, n_out, fn)                              \
  static ::pd_ext::GradRegistrar PD_CONCAT(__pd_greg_, op){#op, n_in,      \
                                                           n_out, fn};

// ---- C ABI the python loader consumes -------------------------------------
extern "C" {

inline int pd_num_ops() { return (int)pd_ext::registry().size(); }

inline const char* pd_op_name(int i) {
  auto& ops = pd_ext::registry();
  return (i >= 0 && i < (int)ops.size()) ? ops[i].name : nullptr;
}

// meta[0]=n_inputs meta[1]=n_outputs meta[2]=has_infer
// meta[3]=grad_n_inputs meta[4]=grad_n_outputs meta[5]=has_grad
inline int pd_op_meta(int i, int64_t* meta) {
  auto& ops = pd_ext::registry();
  if (i < 0 || i >= (int)ops.size()) return -1;
  const auto& r = ops[i];
  meta[0] = r.n_inputs;
  meta[1] = r.n_outputs;
  meta[2] = r.infer != nullptr;
  meta[3] = r.grad_n_inputs;
  meta[4] = r.grad_n_outputs;
  meta[5] = r.bwd != nullptr;
  return 0;
}

inline int pd_infer_shape(int i, const PDTensor* ins, int n_ins,
                          PDTensor* outs, int n_outs) {
  auto& ops = pd_ext::registry();
  if (i < 0 || i >= (int)ops.size()) return -1;
  const auto& r = ops[i];
  if (r.infer) return r.infer(ins, n_ins, outs, n_outs);
  for (int o = 0; o < n_outs; o++) {
    outs[o].ndim = ins[0].ndim;
    memcpy(outs[o].shape, ins[0].shape, sizeof(ins[0].shape));
    outs[o].dtype = ins[0].dtype;
  }
  return 0;
}

inline int pd_run(int i, int is_grad, const PDTensor* ins, int n_ins,
                  PDTensor* outs, int n_outs) {
  auto& ops = pd_ext::registry();
  if (i < 0 || i >= (int)ops.size()) return -1;
  const auto& r = ops[i];
  PDKernelFn fn = is_grad ? r.bwd : r.fwd;
  if (!fn) return -2;
  return fn(ins, n_ins, outs, n_outs);
}

}  // extern "C"

// odr-use the inline C-ABI functions so every extension TU emits them as
// (weak, default-visibility) symbols that dlsym can find
namespace pd_ext {
__attribute__((used)) static void* const kExportKeep[] = {
    (void*)&pd_num_ops,     (void*)&pd_op_name, (void*)&pd_op_meta,
    (void*)&pd_infer_shape, (void*)&pd_run};
}  // namespace pd_ext

#endif  // PD_EXTENSION_H_
