// A served stage's device work as one launch: a stage program's CUDA
// graph holds, around the stage's kernels, the start event, the copies of
// the call's inputs into the program's static inputs, the copies of the
// static outputs into the call's output tensors, and the end event. Each
// call points those nodes at its own events and tensors and launches the
// graph: one burst of driver calls on the calling thread.
//
// No kernel, and it replaces no Pallas kernel: it is the dispatch of the
// reference's jitted stage call (src/repro/serving/engine.py), which XLA
// issues from C++. Issued from Python, the same steps (PyTorch's copy_,
// CUDAGraph.replay and clone, two event records) were separate calls, and
// a host stall between them held the stage's device interval open. In
// the graph the events bracket the device's work and nothing else,
// whenever the host gets to the launch. What bounds it: the driver, a few
// microseconds a call; the node updates touch the executable graph on the
// host, and the launch is one submission.
//
// Capture (on the capturing stream, inside the stream capture):
// repro_stage_capture_event records an event as an event record node,
// repro_stage_capture_copy enqueues a device-to-device copy as a memcpy
// node; each returns the node it added. Launch: repro_stage_launch sets
// the event nodes' events and the copy nodes' pointers that differ from
// what the executable graph holds (a node update is a driver call of a
// few microseconds), then launches,
// and stamps the wall clock (CLOCK_MONOTONIC, which Python's
// time.perf_counter reads, in seconds) after the updates and after the
// launch: a step that takes a millisecond names the driver call that
// stalled.
#include <cuda_runtime.h>
#include <time.h>

static inline void stamp(double* s) {
  timespec wall;
  clock_gettime(CLOCK_MONOTONIC, &wall);
  *s = wall.tv_sec + 1e-9 * wall.tv_nsec;
}

// The node the capture on `s` added last (the capture is a chain).
static cudaError_t last_node(cudaStream_t s, void** node) {
  cudaStreamCaptureStatus status;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, nullptr,
                                             &deps, nullptr, &n);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, nullptr,
                                             &deps, &n);
#endif
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive || n != 1)
    return cudaErrorStreamCaptureUnmatched;
  *node = deps[0];
  return cudaSuccess;
}

extern "C" int repro_stage_capture_event(void* stream, void* event,
                                         void** node) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaEventRecordWithFlags(static_cast<cudaEvent_t>(event),
                                             s, cudaEventRecordExternal);
  if (err == cudaSuccess) err = last_node(s, node);
  return static_cast<int>(err);
}

extern "C" int repro_stage_capture_copy(void* stream, void* dst,
                                        const void* src, long long bytes,
                                        void** node) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDeviceToDevice,
                                    s);
  if (err == cudaSuccess) err = last_node(s, node);
  return static_cast<int>(err);
}

// nodes: the start and end event nodes, then the n_in copies in and the
// n_out copies out. src_in: this call's n_in input sources; dst_in: the
// static inputs; src_out: the n_out static outputs, whose destinations are
// out_base + out_off[i]; bytes: the n_in inputs' then the n_out outputs'
// sizes. last: what each node of the executable graph holds now (its
// event, its copy's source in, its copy's destination out), kept by the
// caller from the capture on: a node whose value is the call's is left as
// it is (the same ring pair, the same input, the same output block), so a
// call sets only what moved. stamps: 2 wall seconds. Returns the first
// CUDA error; nothing is launched after one.
extern "C" int repro_stage_launch(void* stream, void* graph_exec,
                                  void* const* nodes, int n_in, int n_out,
                                  void* start, void* end,
                                  void* const* src_in, void* const* dst_in,
                                  void* const* src_out, char* out_base,
                                  const long long* out_off,
                                  const long long* bytes, void** last,
                                  double* stamps) {
  cudaGraphExec_t g = static_cast<cudaGraphExec_t>(graph_exec);
  cudaError_t err = cudaSuccess;
  void* const events[2] = {start, end};
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    if (last[i] == events[i]) continue;
    err = cudaGraphExecEventRecordNodeSetEvent(
        g, static_cast<cudaGraphNode_t>(nodes[i]),
        static_cast<cudaEvent_t>(events[i]));
    if (err == cudaSuccess) last[i] = events[i];
  }
  for (int i = 0; i < n_in && err == cudaSuccess; ++i) {
    if (last[2 + i] == src_in[i]) continue;
    err = cudaGraphExecMemcpyNodeSetParams1D(
        g, static_cast<cudaGraphNode_t>(nodes[2 + i]), dst_in[i], src_in[i],
        bytes[i], cudaMemcpyDeviceToDevice);
    if (err == cudaSuccess) last[2 + i] = src_in[i];
  }
  for (int i = 0; i < n_out && err == cudaSuccess; ++i) {
    void* dst = out_base + out_off[i];
    if (last[2 + n_in + i] == dst) continue;
    err = cudaGraphExecMemcpyNodeSetParams1D(
        g, static_cast<cudaGraphNode_t>(nodes[2 + n_in + i]), dst, src_out[i],
        bytes[n_in + i], cudaMemcpyDeviceToDevice);
    if (err == cudaSuccess) last[2 + n_in + i] = dst;
  }
  stamp(stamps);
  if (err == cudaSuccess)
    err = cudaGraphLaunch(g, static_cast<cudaStream_t>(stream));
  stamp(stamps + 1);
  return static_cast<int>(err);
}
