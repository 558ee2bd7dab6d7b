// The Radau IIA(5) kernel's event entries (radau.cuh's template with an
// event set): one IVP_RADAU_EVENT_ENTRY a functor and set, in a library of
// its own, so that radau.cu's build and its g++ rehearsals do not grow.
#include "radau.cuh"
#include "events/crossing.cuh"
#include "events/replenish.cuh"

IVP_RADAU_EVENT_ENTRY(vdp, VdP, crossing, Crossing, 128, 4)
IVP_RADAU_EVENT_ENTRY(decay, Decay, replenish, Replenish, 128, 4)

IVP_STIFF_LIBRARY()
