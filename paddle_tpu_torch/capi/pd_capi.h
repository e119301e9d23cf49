/* paddle_tpu_torch C inference API (counterpart of
 * paddle_tpu/capi/pd_capi.h: the same ABI and error contract).
 *
 * Analog of the reference's C API
 * (paddle/fluid/inference/capi_exp/pd_inference_api.h): a plain-C
 * surface over the Predictor so non-Python runtimes (C, C++, Go via cgo,
 * Rust via FFI) can serve models. The reference's C API wraps its C++
 * AnalysisPredictor; here the library embeds a CPython interpreter
 * hosting the port's Predictor, whose program torch.compile builds once
 * per input signature: the same object a pure-Python server would run,
 * so there is no extra per-call dispatch beyond one C->Python hop per
 * Run.
 *
 * Threading contract: calls must come from one thread at a time (the
 * library takes the GIL per call; concurrent callers serialize).
 */
#ifndef PADDLE_TPU_TORCH_CAPI_PD_CAPI_H_
#define PADDLE_TPU_TORCH_CAPI_PD_CAPI_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct PD_Config PD_Config;
typedef struct PD_Predictor PD_Predictor;

/* Start the embedded interpreter and import the bridge. repo_root is
 * prepended to sys.path (pass the directory containing
 * `paddle_tpu_torch/`, or NULL if the package is importable already). Idempotent.
 * Returns 0 on success; on failure PD_GetLastError() explains. */
int PD_Init(const char* repo_root);

/* Message of the most recent failure on this thread's calls (static
 * storage; valid until the next failing call). Never NULL. */
const char* PD_GetLastError(void);

PD_Config* PD_ConfigCreate(void);
void PD_ConfigSetModel(PD_Config* config, const char* model_dir);
/* device: "gpu" (default, the first CUDA card) or "cpu". A card
 * request without CUDA fails PD_PredictorCreate (it never falls back to
 * the CPU); "tpu" fails there too: the TPU library is paddle_tpu's. */
void PD_ConfigSetDevice(PD_Config* config, const char* device);
void PD_ConfigDestroy(PD_Config* config);

/* NULL on failure (see PD_GetLastError). The config stays owned by the
 * caller and may be destroyed right after. */
PD_Predictor* PD_PredictorCreate(const PD_Config* config);

/* Number of inputs; -1 only on error. Models saved without an input
 * spec report positional names (input_0, input_1, ...). */
int PD_PredictorGetInputNum(const PD_Predictor* predictor);
/* Copy input idx's name into buf (NUL-terminated, truncated to cap).
 * Returns the full name length, or -1 on error. */
int PD_PredictorGetInputName(const PD_Predictor* predictor, int idx,
                             char* buf, int cap);

/* Copy a float32 row-major tensor in as input `name`. Returns 0 on
 * success. */
int PD_PredictorSetInputFloat(PD_Predictor* predictor, const char* name,
                              const float* data, const int64_t* shape,
                              int ndim);

/* Execute. Compiles on first call per input signature (cached after —
 * the AnalysisPredictor "analysis" step; Inductor's cache directory
 * carries the compile across processes); returns 0 on success. */
int PD_PredictorRun(PD_Predictor* predictor);

int PD_PredictorGetOutputNum(const PD_Predictor* predictor);
/* Write output idx's dims into shape (up to cap entries). Returns the
 * tensor rank, or -1 on error. */
int PD_PredictorGetOutputShape(const PD_Predictor* predictor, int idx,
                               int64_t* shape, int cap);
/* Copy output idx as float32 into buf (up to cap elements). Returns
 * the total element count, or -1 on error. */
int64_t PD_PredictorGetOutputFloat(const PD_Predictor* predictor, int idx,
                                   float* buf, int64_t cap);

void PD_PredictorDestroy(PD_Predictor* predictor);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* PADDLE_TPU_TORCH_CAPI_PD_CAPI_H_ */
