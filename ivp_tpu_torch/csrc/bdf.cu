// The variable-order BDF ensemble solve's entries without events: the
// kernel template and its launches are bdf.cuh's; bdf_ev.cu holds the event
// entries, in a library of their own.
#include "bdf.cuh"

IVP_BDF_ENTRY(vdp, VdP, 128, 4, 3)
IVP_BDF_ENTRY(decay, Decay, 128, 4, 3)
IVP_BDF_ENTRY(robertson, Robertson, 128, 4, 3)

IVP_STIFF_LIBRARY()
