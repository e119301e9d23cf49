// Demo inference client over the goapi package — the Go analog of the
// C client embedded in tests/test_torch_capi.py, printing the identical
// rank/dim/value format so both are checked by the same comparison.
//
//	demo <repo_root> <model_dir> [device]
//
// device is "gpu" (the default: the card) or "cpu".
package main

import (
	"fmt"
	"os"

	"paddletputorch/goapi"
)

func fail(err error, code int) {
	fmt.Fprintln(os.Stderr, err)
	os.Exit(code)
}

func main() {
	if len(os.Args) < 3 || len(os.Args) > 4 {
		fmt.Fprintln(os.Stderr, "usage: demo <repo_root> <model_dir> [gpu|cpu]")
		os.Exit(2)
	}
	device := "gpu"
	if len(os.Args) > 3 {
		device = os.Args[3]
	}
	if err := goapi.Init(os.Args[1]); err != nil {
		fail(err, 3)
	}
	cfg := goapi.NewConfig()
	cfg.SetModel(os.Args[2])
	cfg.SetDevice(device)
	pred, err := goapi.NewPredictor(cfg)
	cfg.Destroy()
	if err != nil {
		fail(err, 4)
	}
	defer pred.Destroy()

	names, err := pred.GetInputNames()
	if err != nil || len(names) < 1 {
		fail(fmt.Errorf("inputs: %v", err), 5)
	}
	data := make([]float32, 2*8)
	for i := range data {
		data[i] = 0.125 * float32(i-8)
	}
	if err := pred.SetInputFloat32(names[0], data,
		[]int64{2, 8}); err != nil {
		fail(err, 6)
	}
	if err := pred.Run(); err != nil {
		fail(err, 6)
	}
	shape, err := pred.GetOutputShape(0)
	if err != nil {
		fail(err, 8)
	}
	out, err := pred.GetOutputFloat32(0)
	if err != nil {
		fail(err, 9)
	}
	fmt.Printf("rank %d\n", len(shape))
	for _, d := range shape {
		fmt.Printf("dim %d\n", d)
	}
	for _, v := range out {
		fmt.Printf("%.8e\n", v)
	}
}
