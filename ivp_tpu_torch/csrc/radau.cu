// The Radau IIA(5) ensemble solve's entries without events: the kernel
// template and its launches are radau.cuh's; radau_ev.cu holds the event
// entries, in a library of their own.
#include "radau.cuh"

IVP_RADAU_ENTRY(vdp, VdP, 128, 4)
IVP_RADAU_ENTRY(decay, Decay, 128, 4)
IVP_RADAU_ENTRY(robertson, Robertson, 128, 3)

IVP_STIFF_INVERSES()
IVP_STIFF_LIBRARY()
