#pragma once
#include "emu_cuda.h"
