// Package goapi is the Go inference API over libpaddle_tpu_torch_c —
// the analog of the reference framework's paddle/fluid/inference/goapi
// (config -> predictor -> input/output tensors), reduced to the flat C
// surface in ../pd_capi.h.
//
// Build: the shared library is produced by
// paddle_tpu_torch.capi.build_capi() (libpaddle_tpu_torch_c_<hash>.so);
// point cgo at it, e.g.
//
//	CGO_CFLAGS="-I/path/to/paddle_tpu_torch/capi" \
//	CGO_LDFLAGS="-L$LIBDIR -l:$LIBNAME -Wl,-rpath,$LIBDIR" \
//	go build ./...
//
// Threading contract is the C one: calls serialize on the embedded
// interpreter's GIL — use one Predictor from one goroutine at a time.
package goapi

/*
#include <stdint.h>
#include <stdlib.h>
#include "pd_capi.h"
*/
import "C"

import (
	"fmt"
	"unsafe"
)

// lastError wraps PD_GetLastError into a Go error with a call label.
func lastError(op string) error {
	return fmt.Errorf("%s: %s", op, C.GoString(C.PD_GetLastError()))
}

// Init starts the embedded interpreter (idempotent). repoRoot is the
// directory containing the paddle_tpu_torch package, or "" if importable.
func Init(repoRoot string) error {
	var cRoot *C.char
	if repoRoot != "" {
		cRoot = C.CString(repoRoot)
		defer C.free(unsafe.Pointer(cRoot))
	}
	if C.PD_Init(cRoot) != 0 {
		return lastError("Init")
	}
	return nil
}

// Config mirrors the reference goapi Config: model location + device.
type Config struct {
	c *C.PD_Config
}

func NewConfig() *Config {
	return &Config{c: C.PD_ConfigCreate()}
}

// SetModel points the config at a jit.save'd model directory/prefix.
func (cfg *Config) SetModel(modelDir string) {
	cDir := C.CString(modelDir)
	defer C.free(unsafe.Pointer(cDir))
	C.PD_ConfigSetModel(cfg.c, cDir)
}

// SetDevice selects "gpu" (default) or "cpu". A card request without
// CUDA fails NewPredictor; it never falls back to the CPU.
func (cfg *Config) SetDevice(device string) {
	cDev := C.CString(device)
	defer C.free(unsafe.Pointer(cDev))
	C.PD_ConfigSetDevice(cfg.c, cDev)
}

// Destroy releases the config (the predictor does not keep it).
func (cfg *Config) Destroy() {
	if cfg.c != nil {
		C.PD_ConfigDestroy(cfg.c)
		cfg.c = nil
	}
}

// Predictor mirrors the reference goapi Predictor.
type Predictor struct {
	p *C.PD_Predictor
}

func NewPredictor(cfg *Config) (*Predictor, error) {
	p := C.PD_PredictorCreate(cfg.c)
	if p == nil {
		return nil, lastError("NewPredictor")
	}
	return &Predictor{p: p}, nil
}

func (pred *Predictor) GetInputNum() (int, error) {
	n := int(C.PD_PredictorGetInputNum(pred.p))
	if n < 0 {
		return 0, lastError("GetInputNum")
	}
	return n, nil
}

// GetInputNames returns every input name in declaration order (the
// reference goapi's GetInputNames over GetInputNameById).
func (pred *Predictor) GetInputNames() ([]string, error) {
	n, err := pred.GetInputNum()
	if err != nil {
		return nil, err
	}
	names := make([]string, 0, n)
	buf := make([]C.char, 256)
	for i := 0; i < n; i++ {
		ln := C.PD_PredictorGetInputName(pred.p, C.int(i), &buf[0],
			C.int(len(buf)))
		if ln < 0 {
			return nil, lastError("GetInputNames")
		}
		names = append(names, C.GoString(&buf[0]))
	}
	return names, nil
}

// SetInputFloat32 copies a row-major float32 tensor in as input `name`
// (the reference Tensor.CopyFromCpu + Reshape collapsed into one call).
func (pred *Predictor) SetInputFloat32(name string, data []float32,
	shape []int64) error {
	want := int64(1)
	for _, d := range shape {
		want *= d
	}
	if want != int64(len(data)) {
		return fmt.Errorf("SetInputFloat32: %d elements for shape %v",
			len(data), shape)
	}
	cName := C.CString(name)
	defer C.free(unsafe.Pointer(cName))
	var dPtr *C.float
	if len(data) > 0 {
		dPtr = (*C.float)(unsafe.Pointer(&data[0]))
	}
	var sPtr *C.int64_t
	if len(shape) > 0 {
		sPtr = (*C.int64_t)(unsafe.Pointer(&shape[0]))
	}
	if C.PD_PredictorSetInputFloat(pred.p, cName, dPtr, sPtr,
		C.int(len(shape))) != 0 {
		return lastError("SetInputFloat32")
	}
	return nil
}

// Run executes the model (compiles on first call per signature).
func (pred *Predictor) Run() error {
	if C.PD_PredictorRun(pred.p) != 0 {
		return lastError("Run")
	}
	return nil
}

func (pred *Predictor) GetOutputNum() (int, error) {
	n := int(C.PD_PredictorGetOutputNum(pred.p))
	if n < 0 {
		return 0, lastError("GetOutputNum")
	}
	return n, nil
}

// GetOutputShape returns output idx's dims.
func (pred *Predictor) GetOutputShape(idx int) ([]int64, error) {
	buf := make([]C.int64_t, 16)
	rank := C.PD_PredictorGetOutputShape(pred.p, C.int(idx), &buf[0],
		C.int(len(buf)))
	if rank < 0 {
		return nil, lastError("GetOutputShape")
	}
	shape := make([]int64, int(rank))
	for i := range shape {
		shape[i] = int64(buf[i])
	}
	return shape, nil
}

// GetOutputFloat32 copies output idx back as float32 (the reference
// Tensor.CopyToCpu).
func (pred *Predictor) GetOutputFloat32(idx int) ([]float32, error) {
	shape, err := pred.GetOutputShape(idx)
	if err != nil {
		return nil, err
	}
	n := int64(1)
	for _, d := range shape {
		n *= d
	}
	out := make([]float32, n)
	var ptr *C.float
	if n > 0 {
		ptr = (*C.float)(unsafe.Pointer(&out[0]))
	}
	got := C.PD_PredictorGetOutputFloat(pred.p, C.int(idx), ptr,
		C.int64_t(n))
	if got < 0 {
		return nil, lastError("GetOutputFloat32")
	}
	return out[:got], nil
}

// Destroy releases the predictor.
func (pred *Predictor) Destroy() {
	if pred.p != nil {
		C.PD_PredictorDestroy(pred.p)
		pred.p = nil
	}
}
