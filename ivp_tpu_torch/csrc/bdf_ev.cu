// The BDF kernel's event entries (bdf.cuh's template with an event set):
// one IVP_BDF_EVENT_ENTRY a functor and set, in a library of its own, so
// that bdf.cu's build and its g++ rehearsals do not grow.
#include "bdf.cuh"
#include "events/crossing.cuh"
#include "events/replenish.cuh"

IVP_BDF_EVENT_ENTRY(vdp, VdP, crossing, Crossing, 128, 4, 3)
IVP_BDF_EVENT_ENTRY(decay, Decay, replenish, Replenish, 128, 4, 3)

IVP_STIFF_LIBRARY()
