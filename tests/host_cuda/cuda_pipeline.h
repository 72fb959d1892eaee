// The cp.async primitives live in cuda_runtime.h of this emulation.
#pragma once
#include "cuda_runtime.h"
