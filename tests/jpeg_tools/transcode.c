/* Rewrites a JPEG file's entropy coding and scan script, keeping its
 * quantized coefficients (so every output decodes to the input's pixels):
 *
 *   transcode IN OUT [arith] [prog] [script "SCANS"] [rst N] [dac L U K]
 *
 *   arith        arithmetic coding (SOF9, or SOF10 with prog/script)
 *   prog         libjpeg's default progressive script
 *   script S     a progressive script: scans separated by ';', each
 *                "n c0 .. c(n-1) Ss Se Ah Al" (component indices)
 *   rst N        a restart marker every N MCUs
 *   dac L U K    the DC conditioning L, U and the AC Kx of every
 *                arithmetic table (DAC segment)
 *
 * Built against the system libjpeg (libjpeg-turbo with arithmetic coding):
 * cc transcode.c -ljpeg. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

static jpeg_scan_info scans[64];

static int parse_script(const char *p) {
    int ns = 0, used;
    while (*p && ns < 64) {
        jpeg_scan_info *sc = &scans[ns++];
        if (sscanf(p, "%d%n", &sc->comps_in_scan, &used) != 1) return -1;
        p += used;
        for (int k = 0; k < sc->comps_in_scan && k < 4; ++k) {
            if (sscanf(p, "%d%n", &sc->component_index[k], &used) != 1)
                return -1;
            p += used;
        }
        if (sscanf(p, "%d %d %d %d%n", &sc->Ss, &sc->Se, &sc->Ah, &sc->Al,
                   &used) != 4)
            return -1;
        p += used;
        while (*p == ' ' || *p == ';') ++p;
    }
    return ns;
}

int main(int argc, char **argv) {
    if (argc < 3) {
        fprintf(stderr, "usage: transcode IN OUT [arith] [prog] "
                        "[script S] [rst N] [dac L U K]\n");
        return 2;
    }
    FILE *fi = fopen(argv[1], "rb"), *fo = fopen(argv[2], "wb");
    if (!fi || !fo) return 2;
    struct jpeg_decompress_struct src;
    struct jpeg_compress_struct dst;
    struct jpeg_error_mgr e1, e2;
    src.err = jpeg_std_error(&e1);
    dst.err = jpeg_std_error(&e2);
    jpeg_create_decompress(&src);
    jpeg_create_compress(&dst);
    jpeg_stdio_src(&src, fi);
    jpeg_read_header(&src, TRUE);
    jvirt_barray_ptr *coef = jpeg_read_coefficients(&src);
    jpeg_copy_critical_parameters(&src, &dst);
    for (int i = 3; i < argc; ++i) {
        if (!strcmp(argv[i], "arith")) {
            dst.arith_code = TRUE;
        } else if (!strcmp(argv[i], "prog")) {
            jpeg_simple_progression(&dst);
        } else if (!strcmp(argv[i], "script") && i + 1 < argc) {
            int ns = parse_script(argv[++i]);
            if (ns <= 0) return 2;
            dst.scan_info = scans;
            dst.num_scans = ns;
        } else if (!strcmp(argv[i], "rst") && i + 1 < argc) {
            dst.restart_interval = (unsigned)atoi(argv[++i]);
        } else if (!strcmp(argv[i], "dac") && i + 3 < argc) {
            int l = atoi(argv[i + 1]), u = atoi(argv[i + 2]),
                k = atoi(argv[i + 3]);
            i += 3;
            for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
                dst.arith_dc_L[t] = (UINT8)l;
                dst.arith_dc_U[t] = (UINT8)u;
                dst.arith_ac_K[t] = (UINT8)k;
            }
        } else {
            fprintf(stderr, "transcode: bad argument %s\n", argv[i]);
            return 2;
        }
    }
    jpeg_stdio_dest(&dst, fo);
    jpeg_write_coefficients(&dst, coef);
    jpeg_finish_compress(&dst);
    jpeg_finish_decompress(&src);
    jpeg_destroy_compress(&dst);
    jpeg_destroy_decompress(&src);
    fclose(fo);
    fclose(fi);
    return 0;
}
